#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (crdr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py               # from the root of a checkout; one GPU
    python3 chip_smoke.py --profile     # + device time by kernel, idle share,
                                        #   K1's, K2's and K3's shares (and
                                        #   the checkerboard's decode); a
                                        #   training step taken apart
    python3 chip_smoke.py --ab-encode   # + the fixed-batch analysis A/B

Phases, each asserted (any failure exits non-zero):

1. card: the nvidia-smi name / power-limit line; the kernels build from the
   checkout's sources (nvcc for K1, K2, K3 and E1; g++ for the host rANS
   coders and the image decoders, all started together) into
   build/crdr_tpu_torch/.
2. K1 (the Charm SliceTransform kernel) at the main path's shapes: batch 4,
   a 32x48 latent (a 512x768 image), Cin 480 (mean / scale) and 512 (LRP),
   seeded weights in a 10-slice packed stack, slice 7.  The library's SASS
   must hold HGMMA (wgmma) and no HMMA (mma.sync).  The kernel against its
   plain PyTorch twin (TF32 off), bit-stability across calls and batch
   sizes (at batch 2 of a 16x24 latent too, the served 256x384 images'),
   and times: kernel at batch 4 and 1, each of its four launches
   (pad / cast, conv0, conv1, conv2) at batch 4 and 1 from the profiler
   (printed as not measured when the profiler records no device activity),
   its blocks per conv and their residency, plain twin, a cuDNN bf16 conv
   chain from the same f32 x (yardstick only, never called by the port) and
   the bound.  Kernel and cuDNN chain are timed as CUDA-graph replays
   (device time; the eager call's time, host enqueue included, is printed
   beside it).  Then K1's stage times at batch 4 and 1 for other cluster
   splits than the plan's, each held against the twin.
3. main path, compressai wire: the flagship BetaCondInterpCaHyperpriorCharmModel
   at full width from config/crdr_throughput.yaml, seeded random init, on 4
   seeded smooth synthetic 512x768 uint8 images: compress_batch ->
   decompress_batch with the K1 launch count, bit-exact y_hat,
   reconstruction sanity, real vs predicted bpp, a batch-1 decode of stream
   0 and a batch-1 encode of image 0 (both equal to the batch-4 ones), and
   the timings, with a batch-1 decode's with the synthesis at the fixed
   batch and at batch 1, in turns (what the padding costs; every
   compressai-wire path prints it).
4. main path, device wire: the same model (wire_format: device,
   device_wire_encoder: host, set in its options, codec_setup again): the K2
   and K1 launch counts, y_hat bit-exact and equal to the compressai wire's,
   real vs predicted bpp, the decode chain enqueued with no host sync, and
   both wires' timings.
5. K2 (one lane-rans decode round) on the inputs the device-wire decode
   gave it (11 rounds: z, then the 10 y slices; the tables are the real
   ones, with their kernel-ready buffers): kernel == plain twin exactly
   (values, states, pointers), a flipped stream word changes the kernel's
   output, two launches are bit-identical, the global-table instantiation
   equals the plan's; the build's registers and spills (none) from the
   ptxas report and the plan's shared memory a block; times of a batch-4 y
   round and of the z round as CUDA-graph replays (eager beside them), of
   the prologue alone (m = 0), of the global-table instantiation and of the
   twin; cycles a step, measured ((round - prologue) x SM clock / steps,
   the clock sampled with nvidia-smi while the y round runs); the bound;
   and, as text only, two chain estimates (v1's binary search and v2's
   bucket search, at an assumed shared-memory latency).
5a. the SliceTransform's actv on the same flagship (its weights kept,
   ``slice_transform_kwargs: {actv: gelu}`` set and codec_setup again):
   gelu at batch 4 on the compressai wire (launches 0 / 0 / 0 / 0: K1 runs
   ReLU only, as JAX's Pallas kernel, so the chain takes the plain convs)
   and on the device wire with E1 (0 / 11 / 0 / 2), each with the checks
   of phases 3 and 4, y_hat unlike the ReLU model's; lrelu at batch 1 on
   the compressai wire (0 / 0 / 0 / 0, y_hat exact).
6. K3 (GDN / inverse GDN) at the GDN path's three shapes ([4, 192, 256x384
   / 128x192 / 64x96] NCHW f32), both directions, seeded non-symmetric
   gamma: kernel vs plain twin (TF32 off) bit for bit (the count of
   differing elements printed) and elementwise within 2e-5 |plain| + 1e-6,
   a transposed gamma and the wrong direction fail that by > 10x,
   bit-stable across calls and batch 1 vs 4; the build's registers and
   spills (none) from the ptxas report, blocks resident an SM, the
   library's HMMA / HGMMA count (the bf16 mode's tensor-core product: > 0);
   times of the
   kernel (CUDA-graph replay, gamma^T copy included, and eager), the twin,
   the cuBLAS f32 product gamma . x^2 at each shape (yardstick only) and
   the bound.  Then its bf16 mode (transform_dtype: bfloat16) at the same
   shapes both ways, on the same inputs rounded to bf16: against the bf16
   twin on the card, the elements and ulps apart counted, each element the
   composite of a sum within 1 bf16 ulp of the twin's with every later step
   exact (ops/gdn.py bf16_unexplained: 0, whatever order either sum took),
   bit-stable, not blind to a transposed gamma; times (graph replay
   and eager), the twin's, cuBLAS's bf16 product (yardstick only) and the
   bound (bf16 bytes in and out; the products at the bf16 tensor-core
   rate); the build's registers, shared memory and tile of the bf16
   instances.
7. GDN path: the Balle18 mean-scale hyperprior (HyperpriorModel) at full
   width from config/balle18_mean_scale.yaml on the same images, seeded
   init with every GDN's gamma re-drawn non-symmetric, the last analysis
   conv scaled so that y spans several bins, the scale half of the
   hyper-decoder's last bias raised so that the y tables carry the rate:
   the checks of phase 3 with 6 K3 launches per round trip and none of K1
   or K2, and the timings.  Then a yardstick of the synthesis: its
   transposed convs conv_2 and conv_4 as the port runs them and as
   sub-pixel convolutions plus pixel_shuffle (held within f32 tolerance).
   Then the same model at transform_dtype: bfloat16 (set in its options):
   one batch round trip on the compressai wire and one on the device wire
   (E1), 6 K3 launches each and every K3 call on bf16 (K2 2 and E1 2 on
   the device wire), decoded y_hat == the encoder's, real vs predicted
   bpp, the PSNR beside the f32 path's.
8. model classes: the five other config/_base_/model/*.yaml at full width
   (elic_hyperprior, elic_charm, interp_ca_elic_hyperprior,
   interp_ca_elic_charm, beta_cond_interp_ca_elic_hyperprior) with
   crdr_throughput.yaml's codec options laid over each, seeded init, the y
   scale heads raised: the checks of phase 3 with K1 60 launches a round
   trip on the two Charm classes and none on the three hyperprior ones;
   interp_ca_elic_charm also on the device wire (the checks of phase 4,
   K2 11).  Each model is freed before the next.  Phases 8, 9, 13 and 14
   time one round trip a path (SIDE_RUNS) and skip the padding
   measurement; the flagship and the GDN path keep both.
9. TF32 chain: config/crdr_fastchain.yaml (codec_precision: default) on the
   flagship with K1 on, then off, each on both wires (the checks of phases
   3 and 4); TF32 really ran: the hyper-decoder's output on one z under
   TF32 differs from the f32 chain's, by at most 1e-2 of its range; then
   on each wire crdr_throughput.yaml and the two variants timed in turns.
10. entry points: the codec's uint8 -> f32 conversion on the card equals the
   host's uint8_to_tensor on all 256 values; run_model on the flagship at
   rates 0..4 (the encoder's last InterpCA gains spread so the rate
   matters), bpp / PSNR / MS-SSIM finite, bpp rising with the rate;
   validation (beta = max_beta / 2) per image, its bpp within 1e-3 of
   run_model's; then the CLI (python -m crdr_tpu_torch.cli.compress
   config/crdr_throughput.yaml --decompress --batch 4) as a subprocess on
   each wire, the two at once: each .bin equals compress_batch's streams
   (of the PNGs read
   back; equal to those of the uint8 images), each .png decompress_batch's
   image, _avg_bitrate.json their mean real bpp.
11. the device encoder on the flagship's device wire (crdr_throughput.yaml
   built again from its seed, device_wire_encoder: device): the checks of
   phase 4 with K1 60 / K2 11 / E1 2 (a y and a z call) a round trip,
   streams byte-equal to phase 4's host-encoder streams, the encode timed
   in turns with the host encoder; then y spread by a gain on the last
   analysis conv (~20 bins) so symbols leave their CDF rows, with a fixup
   cap of half the fewest escapes an image has: E1 keeps every escape, the
   host coder is never called, the streams equal the host encoder's and
   decode exactly.  E1's calls are recorded.
12. E1 (the device wire's lane encoder) on those calls (y: 10 rounds, K
   128, T 3,840, read where the codec produced it; z: one round of 18,432):
   kernel == plain twin element for element, containers byte-equal to the
   host coder's, a flipped symbol changes the words, two launches
   bit-identical, on the escape run every escape (more than the cap)
   stored and equal to the host coder's; registers and spills from the
   ptxas report; times of the kernel (the op crdr::lane_encode) and of the
   whole wrapper (the op, then the fixups) on y and z as CUDA-graph replays
   (eager beside them), of the fixups alone, of the twin and of the host
   coder on the same symbols; cycles a step (time x the SM clock sampled
   under load / T), beside v1's as PERF.md records it (not measured by
   this run); the bound; and, as text only, a serial-chain estimate.
13. checkerboard: config/cb_stage2.yaml (InterpCaHyperpriorCharmModel with
   ElicCheckerboardCharmContextModel) with crdr_throughput.yaml's codec
   options laid over it, seeded init (the spatial convs non-zero), y scales
   raised: the checks of phase 3 with K1 60 a round trip; the device wire
   with each encoder (the checks of phase 4: K2 21 a decode, 1 z + 2 a
   slice, y_hat equal to the compressai wire's, a sync-free chain; streams
   equal across the encoders); then K1 off on the compressai wire (the
   plain chain, K1 0).
14. the generic device wire: beta_cond_interp_ca_elic_hyperprior (rate
   and beta headers) and the GDN path (balle18_mean_scale.yaml, K3 6 a
   round trip), each on the compressai wire, then the device wire with
   each encoder (K2 2 a decode, y_hat equal to the compressai wire's,
   streams equal across the encoders, real vs predicted bpp), and K2
   against its twin on the long y round (m 491,520, T 3,840 a lane).
   Each model is freed before the next.
15. training (stages 1 and 2) at full width, batch 8, 256x256 crops of the
   recipes' synthetic uint8 data, seed 0, checkpoints in a temporary
   directory, each run through build_trainer(...).train_loop() with the
   kernel counts set to 0 just before it: config/endurance_stage1.yaml
   (elic_charm, HiFiC rate + MSE + LPIPS on its seeded random init,
   mixed precision, aux Adam) for 20 steps, every loss finite and no step
   skipped, the median step time (each step between two synchronizes; its
   quartiles and range), images/s, peak memory, model FLOPs a step
   (forward hooks: 3 x the net's conv / GDN FLOPs + 1.5 x LPIPS's) and
   their share of the bf16 / TF32 / f32 peaks; then 15 steps on one fixed
   batch, the mean total loss of the last 5 below that of the first 5, and
   a checkpoint; the same weights, batch (2 images) and noise through one
   f32 step on the card and on the CPU, TF32 off: at the seeded init,
   losses within 1e-4 and every gradient within a relative L2 error of
   1e-3; at the trained weights, against a float64 CPU step: the ReLU
   gates, max pool picks and lower-bound gates each f32 step sets apart
   from it counted, and with the ReLUs and max pools held to its gates and
   picks the card and the f32 CPU each within those limits of it and of
   each other (with free gates a gradient past the limit passes only where
   some gate differs); endurance_stage2.yaml and cb_stage2.yaml, 12 steps
   each from that checkpoint (the handoff loads every stage-1 tensor and
   keeps the InterpCA / spatial-context ones at init; rate_ind spans its 5
   levels); balle18_mean_scale.yaml's model under the stage-1 recipe in
   f32, 12 steps, K3 6 launches a step and every GDN parameter a gradient
   (the op's backward, crdr::gdn_backward), K3's six calls of a step timed
   (each config's step time over its steps after the first 5); resume: saved at step 3, rebuilt from the
   checkpoint, run to 6 on the same batches, bit-equal to the
   uninterrupted run; the train CLI (python -m crdr_tpu_torch.cli.train
   endurance_stage1.yaml -ti 3) as a subprocess, started with phase 16's
   once stage 1's checkpoint is written, the two beside the card-vs-CPU
   step: checkpoints, loss CSV and config dump written.  One line of training
   figures.
16. stage 3, the multi-rate GAN fine-tune, in phase 15's temporary
   directory: config/endurance_stage3.yaml
   (MultirateBetaCondHrrGanRateDistortionTrainer, the flagship at full
   width, five CLIC21 sub-discriminators, norm none, LPIPS on its seeded
   random init, mixed precision) at batch 8, 256x256, warm-started from
   phase 15's stage-1 checkpoint: the handoff's counts (every stage-1
   tensor of the same name and shape loaded, the InterpCA / beta modules
   at init, D equal to its seeded init); 12 steps through train_loop, the
   last 7 timed (median, quartiles, images/s, peak memory, model FLOPs a
   step with the anchor forward and D's convs and their share of each
   peak), every logged loss finite, no step skipped, rate_ind spanning
   0..4, D's parameters moving, each sub-D moved exactly when its rate was
   sampled, out_d_real / out_d_fake each step and their separation; six
   steps at the top rate (rate_ind 4: the anchor is the batch, one net
   forward) and six at rate 1 (two forwards), in turns, each timed; the same
   weights, batch (2 images), controls and noise through one f32 step on
   the card and on the CPU, TF32 off, at the seeded stage-3 init, and a
   float64 CPU step as the reference with the ReLU / leaky-ReLU gates and
   max pool picks held to its own (G's and D's losses within 1e-4, every
   gradient of G and of D within a relative L2 error of 1e-3, as phase 15
   holds them); resume: saved at step 3, rebuilt, run to 6, bit-equal (G,
   D and its state, the three optimizers, the generators); the train CLI
   on endurance_stage3.yaml (-ti 3) as a subprocess (started in phase 15),
   its warm start the
   stage-1 checkpoint placed at the recipe's path: checkpoints, D's
   included, and the loss CSV written.
17. streams across devices: config/crdr.yaml (f32, K1 off),
   balle18_mean_scale.yaml (K3 / gdn_plain), crdr_throughput.yaml (K1 / its
   bf16 twin) and crdr_fastchain.yaml (TF32 on the card), each built once
   from its seed on the card and, from the card's state_dict, on the CPU;
   one 256x384 crop of an image encoded on each (the CPU's passes at
   512x768 were most of the phase), each device's own round trip exact
   (asserted); printed, not asserted (the port does not promise it): whether
   the streams are byte-equal and the first y byte apart, whether the
   encoders' y_hat are equal and the first element and symbol apart (slice,
   index), the card's stream decoded on the CPU and the CPU's on the card
   (y_hat against the encoder's, or the exception raised), the CPU seconds;
   one cross_device JSON line.
18. serving: the HTTP server (crdr_tpu_torch/serving/) in process on a
   free port, its model built as the serve CLI builds it
   (crdr_throughput.yaml, --max_batch 8 --max_wait_ms 10, every kernel
   library of the path built before it listens), y scales raised: 8
   client threads x 3 waves of POST /compress (q in {0, 1.5, 2, 3.25, 4};
   two clients send 256x384 images, six 512x768), then POST /decompress
   of every .bin (beta in {0, 1.28, 2.56, 5.12}), then one more wave at
   beta 2.56; on the compressai wire, then on the device wire with E1
   (codec_setup again); then the GDN model (balle18_mean_scale.yaml) for
   one wave of 4 requests.  Asserted on each: every served .bin equals
   compress of that image alone at that q; every served PNG equals the
   uint8 decode of that stream alone at that beta (mixed-beta dispatches
   too, the largest difference also printed); a dispatch of 2 or more;
   the kernel launches over the served traffic (counts set to 0 just
   before it) equal the dispatches (counted by wrapping the model's batch
   entry points) times their counts (K1 30 a dispatch, E1 2 an encode and
   K2 11 a decode on the device wire, K3 3 a transform call of 4 images);
   /healthz names the card; a malformed JPEG body gets a 400 and the next
   request on its connection is served; each decode gives its encoder's
   symbols; each kernel's first served call at every shape (batch 2 of the
   small images' 16x24 latent among them) equals its plain twin on the same
   inputs (K1 within 2e-3, K2 and E1 exactly, K3 within its tolerance); a
   .bin with its y string cut or flipped gets a 200 or a 400, and the
   next request is served; the server shuts down drained.  Printed:
   requests/s, p50 / p95 latency by route, the dispatches by size, the
   peak memory (and the part of it the sampled calls hold).
19. the evaluation protocol. (a) the RD sweep, python -m
   crdr_tpu_torch.cli.rd_sweep (its main, in process) on
   crdr_throughput.yaml's seeded init (y scales raised, the encoder's last
   InterpCA gains spread so the rate matters, saved as a .pth.tar), two
   512x768 synthetic PNGs, 17 qualities x betas 0 and 3.84, on the
   compressai wire and on the device wire (E1): launches K1 90 an image
   (30 a 17-image encode and a decode), K2 22 and E1 2 an image on the
   device wire, every K1 / K2 / E1 call at each shape (N 17 among them)
   held against its plain twin, every (image, q) stream of a batch of 17
   equal to the image's batch-1 stream at q, every decode giving its
   encoder's symbols, rd_curve.csv with 34 rows in JAX's columns and bpp
   rising with q; (b) python -m crdr_tpu_torch.cli.calc_metrics on 50
   synthetic 512x768 images and the flagship's decodes, with seeded
   Inception / DISTS weight files in pytorch-fid's and DISTS' layouts (a
   temporary directory) and a random LPIPS: JAX's _metrics.json keys,
   every value finite; the FID of the reals against themselves within
   1e-3 of 2 tr(sigma) (the CLI and this FID each in a process of its own,
   waited for after phase 20: their sqrtm on the host took 12-27 s each);
   Inception features on the card within 1e-3 of the
   largest of the CPU's, DISTS within 1e-4; (c) python -m
   crdr_tpu_torch.cli.bd_rate with the compressai sweep as anchor and the
   device sweep as test, at each beta: PSNR equal on the two wires, the
   BD-rate within the per-quality rate gaps; printed.
20. Cheng20 and HiFiC: Cheng20 (N 192, y 192, the Cheng20 hyper pair to
   384), Cheng20-InterpCA (rate_level 5) and HiFiC (y 220, filters
   60-960, the Balle18 hyper pair 220 -> 192 / 440), configs built in
   memory, seeded init with the GDN edits of phase 7: the checks of phases
   3 and 4 (generic device wire, E1) with K3 6 a round trip on the Cheng20
   families, every K3 call held against gdn_plain, 0 on HiFiC; no warm-up
   or timed round trips (a Cheng20 direction takes 1-2 s): each wire's
   times are its counted round trip's, cold.
   Then Cheng20 at transform_dtype: bfloat16, one round trip on the
   device wire: 6 K3 launches, all bf16, K2 2, E1 2, decoded y_hat == the
   encoder's, its PSNR.
21. resize_range: endurance_r4_stage1.yaml as written (bicubic, uint8)
   on 16 synthetic 512x768 PNG sources in a temporary directory: 5 steps
   through train_loop (losses finite, uint8 crops); the resampler's ms a
   sample at 768x512 and 1024x768, bicubic beside bilinear, the loader's
   wait a step against the step.
22. data parallel: two ranks spawned on the one card over gloo
   (crdr_tpu_torch.parallel.spawn; NCCL refuses two ranks on one GPU),
   4 images each, against one process at batch 8 from the same seed, on
   config/endurance_stage1.yaml at full width (256x256, f32: mixed
   precision and TF32 off), then on the GDN model the same way: each
   rank's rows are the one process's batch, the ranks' parameters equal
   and bit-equal to the same shards taken in one process, losses within
   2e-3 each step, step 1's averaged gradient within 1e-3 relative L2
   per parameter; the parameters after 4 steps against rtol 2e-3 / atol
   2e-5 (JAX's tests/test_trainer_dp.py): the elements past it printed
   with how many have, on some step, averaged gradients more than 1%
   apart in the two runs and, of those, how many a batch-8 gradient no
   farther from 0 than the two are apart (the sign of Adam's update is
   rounding there), and every element whose gradients agree to 1% every
   step held to the tolerance (DP_GRAD_APART); K3 6 a rank-step on the GDN model, each
   rank's K3 calls (3 shapes x GDN / IGDN at 4 images) held against
   gdn_plain on the rank; one step in a group of one rank over NCCL,
   bit-equal to the step alone; the 2 ranks' checkpoint resumed in one
   process, its next step against the ranks'.  Ms a step per rank
   printed, the two ranks sharing one card (no scaling figure).
23. the serving mesh: crdr_throughput.yaml with serving_devices 2 on
   [cuda:0, cuda:0] (two replicas on the one card), 4 images of 512x768,
   on both wires (E1 encoding): streams byte-equal to one device's,
   decodes equal to the encoders' symbols and to one device's images,
   K1 / K2 / E1 launches = 2 shards x the per-dispatch counts, each
   kernel's calls held against its twin at the shard's shapes, then
   warm round trips of the mesh and one device timed in turns; then
   serving_partition: spatial on one 2048x3072 still split 2 ways:
   symbols apart from one device's printed, cross-decode exact both ways,
   peak memory and times of the split and the whole encode / decode; then
   the split across a global operation: HiFiC with InstanceNorm2D
   (channel_norm: False) at full width, one 768x512 image over 2 replicas
   on the device wire (E1) against the same model whole, the tiles
   exchanging each norm's moments: decodes equal to their encoders',
   cross-decode exact both ways, K1 / K2 / K3 / E1 = 0 / 2 / 0 / 2 split
   and whole, one exchange a norm a direction; symbols apart, the image's
   difference and times printed; then
   cli/serve.py with serving_devices 2 and --mesh_devices cuda:0,cuda:0,
   two requests in one dispatch of 2; then the hyper pair against the
   card's free memory: the flagship (crdr.yaml, decode_begin) and the
   Balle18 mean-scale model (generic_params) on one seeded z at 512x768
   and 2048x3072, with the memory free and then with all but 512 MiB
   taken by a held tensor (around the entry: its peak plus 512 MiB),
   every output bit-equal.
24. AOT serving packages (``runtime/aot.py``, the kernels as ``crdr::``
   ops inside ``torch.export`` programs): the flagship recorded at
   4x512x768 and 1x512x768 on the compressai wire and at 4x512x768 on the
   device wire (E1 encoding it),
   the GDN path at both and the checkerboard (cb_stage2.yaml) at 4x512x768
   on the compressai wire, each exported for cuda (every program must
   export; the
   GDN path's for cpu too), with the record and export seconds and the
   package bytes; each package loaded into a freshly built model on the
   same weights: a batch-4 and (but the checkerboard's and the flagship's
   device wire's) a batch-1 round trip byte-equal to the live
   path's streams and pixel-equal decodes, K1 / K2 / K3 / E1 launches
   equal to the live path's counts (section 2 of PERF.md), each op's calls
   held against its twin, hits and misses by program printed and no miss
   at the recorded buckets but in the data-shaped ``rans_round``; phase
   23's batch mesh (two replicas, 4 images each) serving from the
   flagship's package, streams equal to one device's; the GDN package's
   cpu programs (recorded at 1x256x384 too) in a CPU process (4 threads)
   against the CPU live path (printed, not asserted).  The GDN path's and
   the checkerboard's packages are made in processes of their own, beside
   the flagship's; the serve CLI starts in two fresh processes together,
   without and with the flagship's package, meanwhile: seconds to
   listening and to the first /compress.  Then, with nothing else running,
   the flagship's round trips and the package's in turns, batch 4 (and 1
   on the compressai wire),
   and warm one-image /compress and /decompress of the two servers in
   turns, the .bin equal.
25. image input: every fixture of tests/data/jpeg, tests/data/png and
   tests/data/bmp decoded by the port's readers (the host JPEG and PNG
   decoders built with the others in phase 1) on the file path and the
   body path, the pixels' sha256 equal to the digests cv2 and PIL gave,
   the refused ones raising their reason, each small PNG equal through the
   C++ decoder's numpy twin; the truncated JPEGs read on the file path as
   cv2 reads them (also through OpenImageImageDataset) and refused on the
   body path; every fixture of tests/data/webp, gif, pnm, tiff, jpeg2000,
   sunras and hdr decoded on the file path to cv2's digest and on the body
   path to PIL's (the WebP, LZW, JPEG 2000 and run-length decoders built
   in phase 1), the refused ones (where the oracle refuses, and those
   refused on purpose) raising their reason;
   the C++ WebP decoder's ms at 768x512 (lossy and lossless, of
   serve_smoke's synthetic_images: the lossless one equal to those
   pixels) and the GIF decoder's; the JPEG decoder's ms at 768x512 (a
   Mpix); on the file path at 768x512, the arithmetic (sequential,
   progressive), smoothed progressive, JPEG-in-TIFF, GIF and 16-bit TIFF
   decodes' ms; at 768x512, the JPEG 2000 decoder's ms (a reversible JP2,
   an irreversible codestream, a tiled RPCL JP2), a run-length Sun
   raster's (body) and a run-length Radiance file's; python -m
   crdr_tpu_torch.cli.compress (run in process, so its launches count) on
   the flagship's device wire over a WebP named .jpg, a TIFF named .png,
   an arithmetic JPEG, a smoothed truncated progressive JPEG, a JP2, a
   Radiance file and a Sun raster named .jpg beside PNGs of their pixels,
   one batch of 14: each .bin byte-equal to its PNG's, launches K1 60, K2
   11, E1 2, K3 0;
   the C++ PNG decoder's ms at 768x512 (PIL's file and an all-Paeth one)
   beside its numpy twin's; the 768x512 fixture as a JPEG body to
   cli/serve.py's server (crdr_throughput.yaml, device wire, E1): its .bin
   byte-equal to the PNG of the same pixels', the round trip's launches
   those of phase 4 (K1 60, K2 11, E1 2), each kernel's calls held against
   its twin; PIL's 768x512 palette PNG, the lossy WebP and the GIF as
   bodies, each .bin byte-equal to the RGB PNG's of its pixels, the WebP
   and GIF round trips' launches those of the JPEG body's; 3
   steps of crdr_stage_1.yaml (OpenImageImageDataset, LPIPS allow_random)
   on a train_0/ of the fixtures' JPEGs at batch 8: losses finite, the
   sample's ms, the loader's wait a step against the step, os.cpu_count();
   that run with use_wandb (train -wb): its JSONL stream with JAX's keys
   (a loss, an eval_* and a time line at the last step), then
   validation(save_img=True) writing JAX's .jpg names, read back.  JPEG
   output: the port's encoder (built with the decoder) on the photo's
   pixels and on its JPEG's decode, each file's sha256 equal to cv2's in
   digests.json, the ms an encode at 768x512; the served reconstruction
   as a JPEG, read back (its PSNR printed).
26. one JSON line of kernel figures (launches by path, every path above;
   K3's bf16 mode as an entry of its own, gdn_bf16);
27. the ok line.
Imports nothing of JAX or of the JAX package.
"""

import atexit
import contextlib
import gc
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_IMG, IMG_H, IMG_W = 4, 512, 768
# kernel vs plain twin, max |diff|: a one-ulp f32 difference can flip a bf16
# intermediate; measured 4.6e-4 / 4.7e-4 (Cin 480 / 512) on an H100 at
# these inputs, outputs up to ~0.6 (PERF.md)
K1_ATOL = 2e-3
BPP_REL = 0.05       # real vs predicted bpp
TIMED_RUNS = 3       # timed batch round trips per wire (medians printed)
SIDE_RUNS = 1        # the same for the other configs' paths (phases 9-14),
#                      which skip the padding measurement too
H100_BF16_FLOPS = 989e12   # dense, 700 W part (NVIDIA data sheet)
INT32_LANES_PER_SM = 64   # Hopper: 4 partitions x 16 INT32 units (NVIDIA
#                           H100 architecture white paper); times the SM count
#                           and max SM clock, the card's INT32 issue rate
H100_BYTES_PER_S = 3.35e12
SMEM_LATENCY_CYCLES = 30   # an ASSUMED latency of a dependent shared-memory
#                            load on Hopper, not measured: K2's chain
#                            estimates only, printed as text and kept out of
#                            the kernels line (K2's measured figure there is
#                            cycles_per_step)
FP32_FLOPS_PER_SM_CLOCK = 256  # Hopper: 128 FP32 lanes x 2 (FMA); times the
#                                SM count and max SM clock, the f32 peak
# K3 vs its plain twin, elementwise |kernel - plain| <= K3_RTOL |plain| +
# K3_ATOL: f32 sums of C non-negative terms in another order, then rsqrt
K3_RTOL, K3_ATOL = 2e-5, 1e-6
GDN_SHAPES = [(N_IMG, 192, IMG_H // s, IMG_W // s) for s in (2, 4, 8)]
Y_STD = 4.0          # GDN path: y's spread after the analysis gain, in bins


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


PHASE_S = {}  # main's phases: wall seconds, in the order they ran


def timed(label: str, fn, *args):
    """``fn(*args)``, its wall time kept in PHASE_S and printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[label] = time.perf_counter() - t0
    print(f"[{label}: {PHASE_S[label]:.1f} s]", flush=True)
    return out


STARTED = []  # start_proc's processes: any still running are killed at exit


def start_proc(cmd, cwd: str, log: str, env=None) -> dict:
    """Starts ``cmd`` in the background, both its streams to the file
    ``log``; a thread notes when it exits.  ``end_proc`` waits for it."""
    with open(log, "wb") as f:
        proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    STARTED.append(proc)
    p = {"proc": proc, "cmd": cmd, "log": log, "t0": time.perf_counter()}

    def note_exit():
        proc.wait()
        p["t1"] = time.perf_counter()

    p["waiter"] = threading.Thread(target=note_exit, daemon=True)
    p["waiter"].start()
    return p


def end_proc(p: dict, timeout: float = 600) -> tuple:
    """Waits for a process of ``start_proc`` (killed past ``timeout`` s
    from its start); returns (exit code, its output, seconds from its start
    to its exit)."""
    p["waiter"].join(max(0.0, timeout - (time.perf_counter() - p["t0"])))
    if p["waiter"].is_alive():
        p["proc"].kill()
        p["waiter"].join()
    with open(p["log"], errors="replace") as f:
        out = f.read()
    return p["proc"].returncode, out, p["t1"] - p["t0"]


@atexit.register
def stop_started() -> None:
    for proc in STARTED:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each entry function in a build's ptxas
    report, {mangled name: {"registers": n, "spill_bytes": n}}; prints the
    report's register and spill lines."""
    res, entry = {}, None
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
                res[entry] = {"registers": None, "spill_bytes": 0}
            if "registers" not in line and "spill" not in line:
                continue
            print(f"  ptxas {os.path.basename(log)}:", line.strip())
            if entry and "spill stores" in line:
                res[entry]["spill_bytes"] += sum(
                    int(v) for v in re.findall(r"(\d+) bytes spill", line))
            m = re.search(r"Used (\d+) registers", line)
            if entry and m:
                res[entry]["registers"] = int(m.group(1))
    return res


def build_kernels() -> dict:
    """Builds every library in parallel; returns each kernel module's ptxas
    report, {"slice_transform" | "lane_decode" | "gdn" | "lane_encode":
    ptxas_report}."""
    from crdr_tpu_torch import runtime
    from crdr_tpu_torch.ops import gdn as k3
    from crdr_tpu_torch.ops import lane_decode as k2
    from crdr_tpu_torch.ops import lane_encode as e1
    from crdr_tpu_torch.ops import slice_transform as k1
    from crdr_tpu_torch.utils import gif, jpeg, jpeg2000, png, sunras, webp

    results, threads = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - t0)
        except Exception as e:  # reported below, then the run fails
            results[name] = (e, time.perf_counter() - t0)

    for name, fn in (("slice_transform (nvcc sm_90a)", k1.build),
                     ("lane_decode (nvcc sm_90a)", k2.build),
                     ("gdn (nvcc sm_90a)", k3.build),
                     ("lane_encode (nvcc sm_90a)", e1.build),
                     ("host rANS (g++)", runtime.build),
                     ("host JPEG decoder and encoder (g++)", jpeg.build),
                     ("host PNG decoder (g++)", png.build),
                     ("host WebP decoder (g++)", webp.build),
                     ("host LZW decoders, GIF and TIFF (g++)", gif.build),
                     ("host JPEG 2000 decoder (g++)", jpeg2000.build),
                     ("host run-length decoders, Sun raster and Radiance "
                      "(g++)", sunras.build)):
        threads.append(threading.Thread(target=run, args=(name, fn)))
        threads[-1].start()
    for t in threads:
        t.join()
    for name, (res, dt) in results.items():
        check(not isinstance(res, Exception), f"build of {name}: {res}")
        print(f"built {name} in {dt:.1f} s -> {os.path.relpath(res, ROOT)}")
    return {k.__name__.split(".")[-1]: ptxas_report(k.build() + ".log")
            for k in (k1, k2, k3, e1)}


def max_sm_clock_ghz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()[0]) / 1e3


def sm_clock_under_load_ghz(fn, seconds: float = 1.5):
    """The SM clock while ``fn`` runs back to back for ``seconds``: the
    median of nvidia-smi's 100 ms samples taken meanwhile, in GHz, or None
    when nvidia-smi gave none."""
    import torch

    mon = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        mon.terminate()
        out = mon.communicate(timeout=60)[0]
    samples = sorted(float(v) for v in out.split()
                     if re.fullmatch(r"\d+(\.\d+)?", v))
    return samples[len(samples) // 2] / 1e3 if samples else None


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed between two events, so the host's enqueue time (Python,
    the wrapper, the driver) is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_counts(lib: str) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in a built library's
    SASS; raises if cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found: the SASS cannot be counted")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {op: sum(1 for line in sass.splitlines()
                    if re.search(rf"\b{op}\b", line))
            for op in ("HGMMA", "HMMA")}


K1_SESSIONS = []  # (calls, K1 kernel records, host launch records) a session


def k1_stage_ms(fn, calls: int = 10, tries: int = 3):
    """Device time per stage of K1 (its four kernels in launch order: the
    pad / cast pass, conv0, conv1, conv2), mean over ``calls`` calls of
    ``fn``, from the profiler's kernel records.  None when the profiler
    records no device activity at all in ``tries`` sessions: CUPTI allows
    one subscriber a process, so a tracer outside this script, or a CUPTI
    that fails to start, leaves torch.profiler blind.  K1's own time is
    taken with CUDA events and does not depend on this.

    A session with other than 4 K1 kernel records a call fails the run,
    unless the profiler shows that the launches were made and their
    records lost: its host-side launch records (the cudaLaunchKernel* /
    cuLaunchKernel* calls CUPTI traced in the same session) number 4 a
    call, or CUPTI reported dropped records on stderr.  Every launch's
    error code is checked (``_launch`` raises), so a launch the host made
    and the runtime took runs.  Such a session is printed (records by
    stage name, launch records, CUPTI's words) and measured again,
    ``tries`` at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []  # K1 records of each session that recorded device activity
    for _ in range(tries):
        with stderr_of_this_process() as err:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            events = prof.events()
        dev = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        evs = sorted((e for e in dev if "k1_" in e.name),
                     key=lambda e: e.time_range.start)
        if not dev:
            continue
        seen.append(len(evs))
        host = sum(1 for e in events
                   if not str(getattr(e, "device_type", "")).endswith("CUDA")
                   and re.search(r"^cu(da)?LaunchKernel", e.name))
        K1_SESSIONS.append((calls, len(evs), host))
        if len(evs) == 4 * calls:
            break
        names = {}
        for e in evs:
            key = re.sub(r"<.*", "", e.name)[:40]
            names[key] = names.get(key, 0) + 1
        dropped = [ln for ln in err.text().splitlines()
                   if re.search(r"drop", ln, re.I)]
        print(f"K1 profile: {len(evs)} kernel records for {calls} calls "
              f"(expected {4 * calls}): by name {names}; host launch "
              f"records {host}; CUPTI on stderr: {dropped or 'nothing'}")
        if host != 4 * calls and not dropped:
            fail(f"K1 profile: {len(evs)} kernel records and {host} host "
                 f"launch records for {calls} calls (expected {4 * calls} "
                 "each), and no dropped records reported")
        print("K1 profile: every launch was made and CUPTI lost records; "
              "profiling again")
    else:
        if not seen:
            print(f"K1 stage times: not measured (torch.profiler recorded "
                  f"no device activity in {tries} sessions)")
            return None
        fail(f"K1 profile: {seen} kernel records in {tries} sessions of "
             f"{calls} calls (expected {4 * calls} each)")
    names = ("prep", "conv0", "conv1", "conv2")
    out = {k: 0.0 for k in names}
    for i, e in enumerate(evs):
        want = "k1_prep" if i % 4 == 0 else "k1_conv"
        check(want in e.name, f"K1 profile: record {i} is {e.name[:80]}")
        out[names[i % 4]] += e.time_range.elapsed_us() / 1e3 / calls
    return out


class stderr_of_this_process:
    """Captures file descriptor 2 (what C++ libraries, CUPTI's and the
    profiler's among them, write) into a temporary file for the block, and
    echoes it afterwards; ``text()`` gives what was written."""

    def __enter__(self):
        import tempfile

        sys.stderr.flush()
        self._file = tempfile.TemporaryFile(mode="w+b")
        self._saved = os.dup(2)
        os.dup2(self._file.fileno(), 2)
        return self

    def __exit__(self, *exc):
        sys.stderr.flush()
        os.dup2(self._saved, 2)
        os.close(self._saved)
        self._file.seek(0)
        self._text = self._file.read().decode(errors="replace")
        self._file.close()
        sys.stderr.write(self._text)
        return False

    def text(self) -> str:
        return self._text


def stage_text(st) -> str:
    """K1's stage times as printed, or why there are none."""
    if st is None:
        return "not measured (the profiler saw no device activity)"
    return (", ".join(f"{k} {v:.4f}" for k, v in st.items())
            + f" ms, sum {sum(st.values()):.4f} ms")


def k1_hold(x, args, idx: int, tag: str):
    """K1 on ``x`` with slice ``idx`` of the stacks ``args`` against its
    plain twin within K1_ATOL: two launches bit-identical, each image equal
    to its batch-1 launch, and the check's power (a dropped bias or another
    slice's weights must move the output by more than 10 K1_ATOL).
    Returns (max |err|, max |plain|, the two faults' distances)."""
    import torch

    from crdr_tpu_torch.ops.slice_transform import (slice_transform,
                                                    slice_transform_plain)

    own = tuple(t[idx] for t in args)
    out = slice_transform(x, *args, idx)
    again = slice_transform(x, *args, idx)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"{tag}: two launches differ")
    for i in range(x.shape[0]):
        one = slice_transform(x[i:i + 1].contiguous(), *args, idx)
        check(torch.equal(out[i:i + 1], one),
              f"{tag}: batch-{x.shape[0]} image {i} != batch-1 launch")
    plain = slice_transform_plain(x, *own)
    err = float((out - plain).abs().max())
    check(torch.isfinite(out).all(), f"{tag}: non-finite output")
    check(err <= K1_ATOL, f"{tag}: max|kernel - plain| {err} > {K1_ATOL}")
    # the check's power: the faults it must catch move the output more
    no_b4 = float((plain - own[5] - out).abs().max())
    other = slice_transform_plain(x, *(t[idx - 1] for t in args))
    wrong = float((other - out).abs().max())
    check(min(no_b4, wrong) > 10 * K1_ATOL,
          f"{tag}: the check is blind to a dropped bias ({no_b4:.3e}) or "
          f"another slice's weights ({wrong:.3e})")
    print(f"{tag}: max|kernel - plain| {err:.3e} (dropped b4 would give "
          f"{no_b4:.3e}, slice {idx - 1}'s weights {wrong:.3e}); bit-stable "
          f"across calls and batch sizes")
    return err, float(plain.abs().max()), no_b4, wrong


def k1_phase(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from crdr_tpu_torch.ops import slice_transform as k1mod
    from crdr_tpu_torch.ops.slice_transform import (slice_transform,
                                                    slice_transform_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    n, h, w, S, idx = N_IMG, IMG_H // 16, IMG_W // 16, 10, 7
    c0, c1, cout = 224, 128, 32
    sass = sass_counts(k1mod.build())
    check(sass["HGMMA"] > 0 and sass["HMMA"] == 0,
          f"K1's library must use wgmma and no mma.sync: {sass}")
    rows = []
    for cin in (480, 512):
        def uni(shape, fan_in):
            b = 1.0 / fan_in ** 0.5
            return torch.empty(shape, device=dev).uniform_(-b, b, generator=g)

        x = torch.randn((n, h, w, cin), device=dev, generator=g)
        w0 = uni((S, 5, 5, cin, c0), 25 * cin).to(torch.bfloat16)
        w2 = uni((S, 5, 5, c0, c1), 25 * c0).to(torch.bfloat16)
        w4 = uni((S, 3, 3, c1, cout), 9 * c1).to(torch.bfloat16)
        # biases at the outputs' scale, so a dropped bias or another
        # slice's weights fail K1_ATOL (checked below)
        b0, b2, b4 = (0.1 * torch.randn((S, c), device=dev, generator=g)
                      for c in (c0, c1, cout))
        args = (w0, b0, w2, b2, w4, b4)
        own = tuple(t[idx] for t in args)

        err, scale, no_b4, wrong = k1_hold(x, args, idx, f"K1 Cin {cin}")
        # the served small images' latent (256x384), at a batch of 2
        small = torch.randn((2, h // 2, w // 2, cin), device=dev, generator=g)
        k1_hold(small, args, idx, f"K1 Cin {cin} at 2x{h // 2}x{w // 2}")

        # yardstick: cuDNN bf16 convolutions, channels-last, from the same
        # f32 x (the cast is part of the work; not used by the port)
        wl = [t.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) for t in own[0::2]]

        def library():
            y = x.to(torch.bfloat16).permute(0, 3, 1, 2)
            y = torch.relu(F.conv2d(y, wl[0], own[1].to(torch.bfloat16),
                                    padding=2))
            y = torch.relu(F.conv2d(y, wl[1], own[3].to(torch.bfloat16),
                                    padding=2))
            return F.conv2d(y, wl[2], own[5].to(torch.bfloat16), padding=1)

        x1 = x[:1].contiguous()
        # device time per call (CUDA graph), and the eager call's time with
        # the host's enqueue in it
        ms = graph_time_ms(lambda: slice_transform(x, *args, idx))
        ms1 = graph_time_ms(lambda: slice_transform(x1, *args, idx))
        eager_ms = cuda_time_ms(lambda: slice_transform(x, *args, idx), 20)
        stages = k1_stage_ms(lambda: slice_transform(x, *args, idx))
        stages1 = k1_stage_ms(lambda: slice_transform(x1, *args, idx))
        with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                         deterministic=False,
                                         allow_tf32=False):
            lib_ms = graph_time_ms(library)
        plain_ms = cuda_time_ms(lambda: slice_transform_plain(x, *own), 5, 1)
        flops = 2.0 * n * h * w * (25 * cin * c0 + 25 * c0 * c1 +
                                   9 * c1 * cout)
        nbytes = (4 * n * h * w * (cin + cout)
                  + 2 * (25 * cin * c0 + 25 * c0 * c1 + 9 * c1 * cout)
                  + 4 * (c0 + c1 + cout))
        t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        plans = k1mod.slice_transform_plan(h, w, cin, c0, c1, cout)
        grid = []
        for j, p in enumerate(plans):
            occ = k1mod.occupancy(p, last=j == 2)
            tiles = -(-p["tiles_x"] * p["tiles_y"] // p["pair"]) * p["pair"]
            blocks = p["split"] * tiles
            grid.append(dict(blocks_batch1=blocks, blocks=n * blocks,
                             split=p["split"], pair=p["pair"],
                             n_inst=p["n_inst"], **occ))
        row = dict(cin=cin, ms=ms, ms_batch1=ms1, eager_ms=eager_ms,
                   plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   max_abs_err=err, out_max_abs=scale, gflop=flops / 1e9,
                   ms_by_stage=stages, ms_by_stage_batch1=stages1,
                   grid=grid)
        rows.append(row)
        print(f"K1 Cin {cin}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s; eager, host enqueue included, {eager_ms:.4f} ms), "
              f"batch 1 {ms1:.4f} ms, plain {plain_ms:.4f} ms, "
              f"cuDNN bf16 chain {lib_ms:.4f} ms, bound "
              f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}); max|err| "
              f"{err:.3e} of |out| <= {scale:.3f} (dropped b4 would give "
              f"{no_b4:.3e}, slice {idx - 1}'s weights {wrong:.3e}); "
              f"bit-stable across calls and batch sizes [{card}]")
        print(f"K1 Cin {cin} by stage, batch {n}: {stage_text(stages)}; "
              f"batch 1: {stage_text(stages1)}; blocks (batch 1 / {n}), "
              "split x multicast pair, wgmma N, blocks per SM, clusters "
              "resident, shared memory: "
              + "; ".join(f"conv{j} {q['blocks_batch1']} / {q['blocks']}, "
                          f"{q['split']} x {q['pair']}, N {q['n_inst']}, "
                          f"{q['blocks_per_sm']}/SM, {q['clusters']} "
                          f"clusters, {q['smem_bytes']} B"
                          for j, q in enumerate(grid)) + f" [{card}]")
    print(f"K1 library SASS: {sass['HGMMA']} HGMMA, {sass['HMMA']} HMMA")
    return {"by_cin": {r["cin"]: r for r in rows}, "sass": sass}


def k1_split_phase(card: str, splits=((1, 1, 1), (2, 2, 2), (4, 4, 4),
                                        (8, 8, 4), (8, 8, 8))) -> None:
    """K1's device time by stage at batch 4 and 1 (Cin 480, 32x48) for other
    cluster splits than the plan's: the measurement the default split was
    chosen from."""
    import torch

    from crdr_tpu_torch.ops import slice_transform as k1mod

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    h, w, cin, c0, c1, cout = IMG_H // 16, IMG_W // 16, 480, 224, 128, 32
    x = torch.randn((N_IMG, h, w, cin), device=dev, generator=g)
    args = []
    for shape in ((1, 5, 5, cin, c0), (1, c0), (1, 5, 5, c0, c1), (1, c1),
                  (1, 3, 3, c1, cout), (1, cout)):
        b = (1.0 / np.prod(shape[1:4]) ** 0.5 if len(shape) == 5 else 0.1)
        args.append(torch.empty(shape, device=dev).uniform_(-b, b,
                                                            generator=g))
    plain = k1mod.slice_transform_plain(x, *(t[0] for t in args))
    for j in (0, 2, 4):
        args[j] = args[j].to(torch.bfloat16)
    for sp in splits:
        plan = tuple(k1mod.plan_ints(k1mod.slice_transform_plan(
            h, w, cin, c0, c1, cout, sp)))
        out = k1mod._launch(x, *args, 0, plan)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        check(err <= K1_ATOL, f"K1 split {sp}: max|kernel - plain| {err}")
        for xb in (x, x[:1].contiguous()):
            st = k1_stage_ms(lambda: k1mod._launch(xb, *args, 0, plan))
            print(f"K1 split {sp} batch {xb.shape[0]}: {stage_text(st)} "
                  f"[{card}]")
    kinds = {}
    for sess in K1_SESSIONS:
        kinds[sess] = kinds.get(sess, 0) + 1
    print("K1 profile sessions so far, by (calls, K1 kernel records, host "
          f"launch records): {kinds}")


def smooth_images(seed: int) -> np.ndarray:
    """N_IMG seeded smooth 512x768 uint8 images (the serve smoke's
    ``--synthetic`` images)."""
    from crdr_tpu_torch.cli.serve_smoke import synthetic_images

    return synthetic_images(N_IMG, IMG_H, IMG_W, seed)


def profile_phase(fn, label: str, card: str, kernels=()) -> None:
    """Device time by kernel and the device's busy share over ``fn()``
    (one stream: the kernels' summed time is the busy time); for each name
    in ``kernels``, the share of the device time whose name contains it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):  # device-side events only (kernels, copies, memsets)
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            return 0.0
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if dev_us(e) > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"profile {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.3f} [{card}]")
    for us, count, key in rows[:12]:
        print(f"  {us / 1e3:9.2f} ms {us / 1e4 / max(busy, 1e-9):6.1f}% "
              f"x{count:<5d} {key[:100]}")
    for kernel in kernels:
        mine = sum(r[0] for r in rows if kernel in r[2]) / 1e6
        print(f"  {kernel}: {mine * 1e3:.3f} ms, {mine / max(busy, 1e-9):.3f} "
              f"of the device time")


def raise_y_scales(model, bias: float = 8.0) -> None:
    """At the random init y is near 0 and z carries most of the rate;
    biasing the y scale heads (sigma ~ 8) makes the y Gaussian tables carry
    it, so the real-vs-predicted check exercises them (within 1% at 128x192
    on the CPU twin).  The heads: the Charm scale transforms' last conv, or
    the hyper-decoder's scale half."""
    import torch

    with torch.no_grad():
        if model.use_charm:
            for st in model.net.context_model.scale_slice_transforms:
                st.model[4].bias += bias
        else:
            model.net.hyperdecoder.hd_std.conv3.bias += bias


def build_model(card: str):
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import Config

    cfg = Config.from_file(os.path.join(ROOT, "config",
                                        "crdr_throughput.yaml"))
    t0 = time.perf_counter()
    model = build_comp_model(cfg)  # the GPU; seeded init (cfg seed / 0)
    raise_y_scales(model)
    model.codec_setup()
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in model.net.parameters())
    print(f"flagship {cfg.model_type}: {nparam / 1e6:.1f}M params, "
          f"fused_slice_kernel={model.fused_slice_kernel}, transform_dtype="
          f"{model.transform_dtype}, built in {time.perf_counter() - t0:.1f} "
          f"s [{card}]")
    check(model.fused_slice_kernel, "crdr_throughput.yaml must enable K1")
    return model


RATE, BETA = 2.0, 2.56


def round_trip(model, imgs):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encs = model.compress_batch(imgs, rate_ind=RATE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dec = model.decompress_batch([e["string_list"] for e in encs], beta=BETA)
    torch.cuda.synchronize()
    return encs, dec, t1 - t0, time.perf_counter() - t1


def counted_round_trip(model, imgs):
    """One batch round trip with every kernel's launch count set to 0 just
    before it; returns (encs, decoded, enc s, dec s, {kernel: launches})."""
    kernels = kernel_wrappers()
    for k in kernels.values():
        k.launches = 0
    out = round_trip(model, imgs)
    return out + ({n: k.launches for n, k in kernels.items()},)


def kernel_wrappers() -> dict:
    """{name: wrapper} of every kernel (each wrapper counts its launches)."""
    from crdr_tpu_torch.ops.gdn import gdn
    from crdr_tpu_torch.ops.lane_decode import lane_decode_round
    from crdr_tpu_torch.ops.lane_encode import lane_encode_rounds
    from crdr_tpu_torch.ops.slice_transform import slice_transform

    return {"slice_transform": slice_transform,
            "lane_decode_round": lane_decode_round, "gdn": gdn,
            "lane_encode_rounds": lane_encode_rounds}


def check_round_trip(label, encs, fake, y_hat) -> None:
    y_enc = np.concatenate([e["y_hat"] for e in encs])
    check(np.array_equal(y_hat, y_enc), f"{label}: decoded y_hat != encoder "
                                        "y_hat")
    check(fake.shape == (N_IMG, IMG_H, IMG_W, 3), f"recon shape {fake.shape}")
    check(np.isfinite(fake).all(), f"{label}: non-finite reconstruction")
    check(fake.min() >= -1.0 and fake.max() <= 1.0 and fake.std() > 0,
          f"{label}: reconstruction out of [-1, 1] or constant")
    for i, e in enumerate(encs):
        real = sum(len(s) for s in e["string_list"][1:]) * 8 / (IMG_H * IMG_W)
        pred = e["pred_y_bpp"] + e["pred_z_bpp"]
        print(f"{label} image {i}: real {real:.4f} bpp, predicted "
              f"{pred:.4f} bpp")
        check(abs(real - pred) <= BPP_REL * pred,
              f"{label} image {i}: real bpp {real} vs predicted {pred}")


def timed_runs(model, imgs, label: str, card: str,
               runs: int = TIMED_RUNS) -> dict:
    """Median encode / decode ms over ``runs`` batch round trips."""
    enc, dec = [], []
    for _ in range(runs):
        *_, e, d = round_trip(model, imgs)
        enc.append(e * 1e3)
        dec.append(d * 1e3)
    res = {"encode_ms": float(np.median(enc)), "decode_ms":
           float(np.median(dec)), "encode_runs_ms": enc, "decode_runs_ms": dec}
    mpix = N_IMG * IMG_H * IMG_W / 1e6
    print(f"{label} batch {N_IMG} {IMG_W}x{IMG_H}, median of {runs}: "
          f"encode {res['encode_ms']:.1f} ms, decode {res['decode_ms']:.1f} "
          f"ms, {mpix / (res['encode_ms'] + res['decode_ms']) * 1e3:.4f} "
          f"Mpix/s (encode runs {[round(v, 1) for v in enc]}, decode runs "
          f"{[round(v, 1) for v in dec]}) [{card}]")
    return res


def host_wire_path(model, imgs, label: str, expected: dict, card: str,
                   runs: int = TIMED_RUNS, padding: bool = True):
    """A model on the compressai wire: kernel counts (``expected``, by
    kernel, per batch round trip), checks, batch-1 equality, times (the
    median of ``runs`` round trips; with ``padding``, what the fixed-batch
    synthesis costs a batch-1 decode).  ``runs`` 0: no warm-up round trips
    and no timed ones, the times those of the counted round trip, the
    model's first (cold).  A model without rates or beta ignores RATE and
    BETA."""
    import torch

    expected = {"lane_encode_rounds": 0, **expected}
    if runs:
        round_trip(model, imgs)  # warm-up: cuDNN / library initialization
    encs, (fake, _, y_hat), enc_s, dec_s, counts = \
        counted_round_trip(model, imgs)
    check(counts == expected, f"{label}: kernel launches in one batch round "
                              f"trip {counts} (expected {expected})")
    check_round_trip(label, encs, fake, y_hat)
    dec_timing = model.last_decode_timing  # of the batch decode

    # batch 1 is a new shape for the decode's cuDNN calls: warm it up first
    if runs:
        model.decompress(model.compress(imgs[:1], rate_ind=RATE)[
            "string_list"], beta=BETA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc1 = model.compress(imgs[:1], rate_ind=RATE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, _, y0 = model.decompress(encs[0]["string_list"], beta=BETA)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(np.array_equal(y0, encs[0]["y_hat"]),
          f"{label}: batch-1 decode of stream 0 != encoder y_hat")
    # the analysis runs at one fixed batch size: an image's stream does not
    # depend on the batch it was encoded in
    check(enc1["string_list"] == encs[0]["string_list"],
          f"{label}: batch-1 encode of image 0 != its batch-4 stream (y_hat "
          f"max |diff| "
          f"{float(np.abs(enc1['y_hat'] - encs[0]['y_hat']).max()):.3e})")
    print(f"{label}: batch-1 encode of image 0 equals its batch-{N_IMG} "
          "stream")
    print(f"{label} batch-1{'' if runs else ' (cold)'}: encode "
          f"{(t1 - t0) * 1e3:.1f} ms, decode {(t2 - t1) * 1e3:.1f} ms; one "
          f"batch round trip{'' if runs else ' (cold)'}: encode "
          f"{enc_s * 1e3:.1f} ms, decode {dec_s * 1e3:.1f} ms; launches "
          f"{counts} [{card}]")
    print(f"timing of the batch round trip: encode "
          f"{json.dumps(encs[0]['timing'])} decode {json.dumps(dec_timing)}")
    times = timed_runs(model, imgs, label, card, runs) if runs else {
        "encode_ms": enc_s * 1e3, "decode_ms": dec_s * 1e3, "cold": True}
    if padding:
        times["batch1_decode_ms"] = padding_cost(
            model, encs[0]["string_list"], label, card)
    return encs, counts, times


def padding_cost(model, strings, label: str, card: str,
                 pairs: int = 3) -> dict:
    """Batch-1 decode ms of ``strings`` with the synthesis at the codec's
    fixed batch (padded with zero latents, as it runs) and, for this
    measurement only, at batch 1 (``TRANSFORM_BATCH`` set to 1), in turns
    (A B B A, ``pairs`` times): what the fixed batch costs a lone image."""
    import torch

    from crdr_tpu_torch.models import codec

    fixed, runs = codec.TRANSFORM_BATCH, {}
    try:
        for tb in (1, fixed):  # batch 1 is a new shape for cuDNN: warm up
            codec.TRANSFORM_BATCH = tb
            model.decompress(strings, beta=BETA)
        for tb in (fixed, 1, 1, fixed) * pairs:
            codec.TRANSFORM_BATCH = tb
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decompress(strings, beta=BETA)
            torch.cuda.synchronize()
            runs.setdefault(tb, []).append((time.perf_counter() - t0) * 1e3)
    finally:
        codec.TRANSFORM_BATCH = fixed
    med = {tb: float(np.median(r)) for tb, r in runs.items()}
    print(f"{label} batch-1 decode, medians of {2 * pairs} in turns (A B B "
          f"A): synthesis at the fixed batch of {fixed} {med[fixed]:.1f} ms, "
          f"at batch 1 {med[1]:.1f} ms: the padding costs "
          f"{med[fixed] - med[1]:.1f} ms (runs {fixed}: "
          f"{[round(v, 1) for v in runs[fixed]]}, 1: "
          f"{[round(v, 1) for v in runs[1]]}) [{card}]")
    return {"fixed_batch": med[fixed], "batch_1": med[1]}


def device_wire_expected(model, encoder: str, gdn: int = 0) -> dict:
    """Kernel launches of one device-wire batch round trip: K2 1 z round +
    a round per slice (Charm), two per slice (checkerboard) or one
    (generic); K1 (when on, and the SliceTransforms ReLU) 3 SliceTransforms
    a slice each way; E1 a y and a z call per encode with the device
    encoder; ``gdn`` K3 calls."""
    if model._is_checkerboard:
        k2 = 1 + 2 * model.num_slices
    elif model.use_charm:
        k2 = 1 + model.num_slices
    else:
        k2 = 2
    k1 = 6 * model.num_slices if model.use_charm and \
        model.fused_slice_kernel and model.slice_actv == "relu" else 0
    return {"slice_transform": k1, "lane_decode_round": k2, "gdn": gdn,
            "lane_encode_rounds": 2 if encoder == "device" else 0}


def device_chain(model):
    """The family's device-wire decode chain (launches only)."""
    if model._is_checkerboard:
        return model._cb_device_chain
    return model._charm_device_chain if model.use_charm \
        else model._generic_device_chain


def device_wire_path(model, imgs, y_compressai, card: str,
                     label: str = "device wire", encoder: str = "host",
                     gdn: int = 0, runs: int = TIMED_RUNS):
    """The device wire on the same model, lane-encoded by ``encoder``:
    counts, checks, a sync-free decode chain, a batch-1 stream equal to its
    batch-4 stream, times.  Returns (the K2 inputs the warm-up decode
    recorded, counts, times, the batch's encodings).  ``runs`` 0: no
    warm-up (nothing recorded) and no timed round trips, the times those
    of the counted round trip (cold)."""
    import torch

    from crdr_tpu_torch.models import codec_devicewire
    from crdr_tpu_torch.models.codec import codec_numerics

    model.opt.update(wire_format="device", device_wire_encoder=encoder)
    model.codec_setup()
    check(model.wire_format == "device", "the device wire is not set")
    real, recorded = codec_devicewire.lane_decode_round, []

    def recorder(*args):  # K2's inputs, as the decode gives them
        recorded.append(tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args))
        return real(*args)

    codec_devicewire.lane_decode_round = recorder
    try:
        if runs:
            round_trip(model, imgs)  # warm-up, and K2's inputs for its phase
    finally:
        codec_devicewire.lane_decode_round = real
    encs, (fake, _, y_hat), enc_s, dec_s, counts = \
        counted_round_trip(model, imgs)
    expected = device_wire_expected(model, encoder, gdn)
    check(counts == expected, f"{label}: kernel launches in one batch "
                              f"round trip {counts} (expected {expected})")
    check(all(e["string_list"][2][:4] == b"CRDW" for e in encs),
          f"{label}: the y streams are not lane containers")
    check_round_trip(label, encs, fake, y_hat)
    check(np.array_equal(y_hat, y_compressai),
          f"{label}: y_hat != the compressai wire's y_hat of the same images")
    rate = {"rate_ind": RATE} if model.use_rate else {}
    one = model.compress(imgs[:1], **rate)
    check(one["string_list"] == encs[0]["string_list"],
          f"{label}: batch-1 encode of image 0 != its batch-4 stream")

    # the decode chain enqueues every launch without a host sync
    strings = [e["string_list"] for e in encs]
    zh, zw = IMG_H // model.model_stride, IMG_W // model.model_stride
    with codec_numerics(model._chain_tf32):
        z, y_lanes = model._device_wire_inputs(
            [s[1] for s in strings], [s[2] for s in strings], zh, zw)
        ri = model._cond_arg(RATE, N_IMG) if model.use_rate else None
        bt = model._cond_arg(BETA, N_IMG) if model.use_beta else None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            chain = device_chain(model)(z, y_lanes, zh, zw, ri, bt)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    check(np.array_equal(chain[2].cpu().numpy(), y_hat),
          f"{label}: the checked decode chain gave another y_hat")
    print(f"{label}: decode chain ({chain_name(model)}) enqueued with no "
          "host sync (sync debug mode 'error'); batch-1 encode of image 0 "
          f"equals its batch-{N_IMG} stream")
    print(f"{label} one batch round trip{'' if runs else ' (cold)'}: "
          f"encode {enc_s * 1e3:.1f} ms, decode {dec_s * 1e3:.1f} ms; "
          f"launches {counts} [{card}]")
    print(f"timing encode {json.dumps(encs[0]['timing'])} decode "
          f"{json.dumps(model.last_decode_timing)}")
    times = timed_runs(model, imgs, label, card, runs) if runs else {
        "encode_ms": enc_s * 1e3, "decode_ms": dec_s * 1e3, "cold": True}
    return recorded, counts, times, encs


def chain_name(model) -> str:
    if model._is_checkerboard:
        return ("z round, cb_begin, per slice cb_a_dev, a K2 anchor round, "
                "cb_b_dev, a K2 non-anchor round, cb_final")
    if model.use_charm:
        return ("z round, decode_begin, the slice steps with their K2 "
                "rounds, decode_final")
    return "z round, generic_params, one K2 round, + mean, synthesis"


def set_slice_actv(model, actv: str) -> None:
    """The built flagship as ``crdr_throughput.yaml`` with
    ``slice_transform_kwargs: {actv: ...}`` builds it (its weights do not
    depend on the activation): the key in the model's options, the net's
    SliceTransforms' activations, then codec_setup."""
    from crdr_tpu_torch.subnet.context_model.charm import (Activation,
                                                           SliceTransform)

    kw = {"actv": actv}
    model.opt["subnet"]["context_model"]["slice_transform_kwargs"] = kw
    model.net.subnet_opt["context_model"]["slice_transform_kwargs"] = \
        dict(kw)
    for m in model.net.context_model.modules():
        if isinstance(m, SliceTransform):
            m.model[1], m.model[3] = Activation(actv), Activation(actv)
    model.codec_setup()
    check(model.slice_actv == actv, f"codec_setup read actv "
          f"{model.slice_actv!r}, not {actv!r}")


def slice_actv_check(model, imgs, y_relu, card: str) -> tuple:
    """The SliceTransform's ``actv`` on the flagship at full width (the
    model of phases 3-5, ``fused_slice_kernel`` on): ``gelu`` at batch 4 on
    the compressai wire (K1 / K2 / K3 / E1 0 / 0 / 0 / 0: K1 runs ReLU
    only, as JAX's kernel) and on the device wire with E1 (0 / 11 / 0 /
    2), the checks of phases 3 and 4 (decoded y_hat == the encoder's,
    equal on both wires, real vs predicted bpp, batch-1 streams == batch-4
    streams, a sync-free decode chain), y_hat unlike the ReLU model's;
    then ``lrelu`` at batch 1 on the compressai wire (0 / 0 / 0 / 0, y_hat
    exact).  Leaves the model at ReLU on the compressai wire.  Returns
    ({figures}, {path: launches})."""
    res, counts = {}, {}
    model.opt.update(wire_format="compressai")
    set_slice_actv(model, "gelu")
    encs, counts["gelu compressai"], res["gelu compressai"] = \
        host_wire_path(model, imgs, "gelu compressai wire",
                       {"slice_transform": 0, "lane_decode_round": 0,
                        "gdn": 0}, card, runs=0, padding=False)
    y_gelu = np.concatenate([e["y_hat"] for e in encs])
    check(not np.array_equal(y_gelu, y_relu),
          "gelu: y_hat equals the ReLU model's (the activation unused)")
    _, counts["gelu device"], res["gelu device"], _ = device_wire_path(
        model, imgs, y_gelu, card, label="gelu device wire",
        encoder="device", runs=0)
    model.opt.update(wire_format="compressai")
    set_slice_actv(model, "lrelu")
    encs, (fake, _, y_hat), enc_s, dec_s, got = counted_round_trip(
        model, imgs[:1])
    want = {"slice_transform": 0, "lane_decode_round": 0, "gdn": 0,
            "lane_encode_rounds": 0}
    check(got == want, f"lrelu batch 1: launches {got}, expected {want}")
    check(np.array_equal(y_hat, encs[0]["y_hat"]),
          "lrelu batch 1: decoded y_hat != encoder y_hat")
    check(fake.shape == (1, IMG_H, IMG_W, 3) and np.isfinite(fake).all(),
          f"lrelu batch 1: reconstruction {fake.shape}, finite "
          f"{bool(np.isfinite(fake).all())}")
    counts["lrelu compressai batch 1"] = got
    res["lrelu compressai batch 1"] = {"encode_ms": enc_s * 1e3,
                                       "decode_ms": dec_s * 1e3}
    set_slice_actv(model, "relu")
    print(f"SliceTransform actv: gelu on the flagship at full width, batch "
          f"{N_IMG}, launches {counts['gelu compressai']} (compressai) and "
          f"{counts['gelu device']} (device wire, E1), y_hat equal on both "
          f"wires and to the decode; lrelu batch 1 {got}, y_hat exact; cold "
          f"round trips ms: " + json.dumps(res) + f" [{card}]")
    return res, counts


def k2_bound(st, pt_in, pt_out, idx, cdf_len, clock_ghz: float) -> dict:
    """Bytes / operations figures of one K2 round on these inputs (the words
    it consumed, each symbol's binary-search depth over its row)."""
    import torch

    n, m = idx.shape
    k = st.shape[1]
    lens = cdf_len.long()[idx.long()]
    depth = torch.ceil(torch.log2((lens - 1).clamp(min=1).double())).long()
    nbytes = (4 * 2 * n * m                              # idx in, vals out
              + 2 * int((pt_out - pt_in).sum())          # 16-bit words read
              + (8 + 4) * 2 * n * k                      # states, ptrs in/out
              + 4 * int(cdf_len.sum()) + 4 * 2 * cdf_len.numel())
    ops = int((2 * depth + 12).sum())  # search + state update, per symbol
    int32_rate = (torch.cuda.get_device_properties(0).multi_processor_count
                  * INT32_LANES_PER_SM * clock_ghz * 1e9)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / int32_rate
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, int32_rate=int32_rate,
                mean_search_depth=float(depth.double().mean()))


def k2_chain_ms(levels, k: int, loads: int, clock_ghz: float) -> float:
    """A chain estimate of one round: a warp's step waits for its deepest
    lane's ``levels`` (search loads, [N, m]) plus ``loads`` other dependent
    loads, each SMEM_LATENCY_CYCLES; the round waits for its slowest warp."""
    import torch

    n, m = levels.shape
    t_steps, warps = -(-m // k), -(-k // 32)
    d = torch.nn.functional.pad(levels.long(), (0, t_steps * k - m))
    d = torch.nn.functional.pad(d.reshape(n, t_steps, k),
                                (0, warps * 32 - k))
    warp_steps = (d.reshape(n, t_steps, warps, 32).amax(-1) + loads).sum(1)
    return float(warp_steps.max()) * SMEM_LATENCY_CYCLES / clock_ghz * 1e-6


def k2_launch_global(args):
    """One launch of K2's global-table instantiation on a round's inputs,
    past the plan, for its time; the wrapper's launch count does not see
    it."""
    from crdr_tpu_torch.ops.lane_decode import launch_round

    return launch_round(*args, plan={"in_smem": False})


def k2_phase(recorded, rounds: int, card: str, ptxas: dict) -> dict:
    """K2 against its twin on the main path's recorded rounds (z, then the
    y slices), then its times; ``ptxas`` is the lane_decode library's
    ``ptxas_report``."""
    import torch

    from crdr_tpu_torch.ops.device_rans import lane_decode_round_instep
    from crdr_tpu_torch.ops.lane_decode import (lane_decode_round,
                                                lane_decode_round_lookup,
                                                lane_plan, smem_cap)

    def plain(st, pt, words, idx, table, m):
        return lane_decode_round_instep(st, pt, words, idx, table.cdf,
                                        table.cdf_len, table.cdf_off, m)

    check(len(recorded) == rounds, f"recorded {len(recorded)} K2 rounds, "
                                   f"expected {rounds}")
    err = 0
    for r, args in enumerate(recorded):
        got = lane_decode_round(*args)
        again = lane_decode_round(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        for a, b, c, name in zip(got, again, ref,
                                 ("values", "states", "pointers")):
            check(torch.equal(a, b), f"K2 round {r}: two launches differ in "
                                     f"{name}")
            err = max(err, int((a.long() - c.long()).abs().max()))
            check(torch.equal(a, c), f"K2 round {r}: kernel != plain twin in "
                                     f"{name}")
    # the check's power: one flipped word of a lane this round reads
    y, z = recorded[1], recorded[0]  # y slice 0, the z round
    st, pt, words, idx, table, m = y
    _, _, pt_out = lane_decode_round(*y)
    lane = int(torch.argmax((pt_out - pt)[0]))
    bad = words.clone()
    bad[0, lane, int(pt[0, lane])] ^= 0x5A5A
    flipped = lane_decode_round(st, pt, bad, idx, table, m)
    ref = lane_decode_round(*y)
    check(not all(torch.equal(a, b) for a, b in zip(flipped, ref)),
          "K2: a flipped stream word left the output unchanged")
    glob = k2_launch_global(y)
    check(all(torch.equal(a, b) for a, b in zip(glob, ref)),
          "K2: the global-table instantiation != the shared-memory one")

    # the build: every instantiation's registers, no spills
    build = {e: r for e, r in ptxas.items() if "lane_decode_round_kernel" in e}
    check(len(build) == 2 and all(r["registers"] for r in build.values()),
          f"K2's ptxas report: {ptxas}")
    check(not any(r["spill_bytes"] for r in build.values()),
          f"K2 spills registers: {build}")

    def inst(plan):  # the instantiation's mangled-name tail
        return f"ILb{int(plan['in_smem'])}E"

    cap = smem_cap(st.device)
    plan_y = lane_plan(st.shape[1], table.buf.numel(), cap)
    plan_z = lane_plan(z[0].shape[1], z[4].buf.numel(), cap)
    regs = next(r["registers"] for e, r in build.items() if inst(plan_y) in e)
    max_clock = max_sm_clock_ghz()
    ms = graph_time_ms(lambda: lane_decode_round(*y))
    eager_ms = cuda_time_ms(lambda: lane_decode_round(*y), 50, warmup=3)
    z_ms = graph_time_ms(lambda: lane_decode_round(*z))
    z_eager_ms = cuda_time_ms(lambda: lane_decode_round(*z), 50, warmup=3)
    pro_ms = graph_time_ms(lambda: lane_decode_round(*y[:5], 0))
    pro_z_ms = graph_time_ms(lambda: lane_decode_round(*z[:5], 0))
    glob_ms = graph_time_ms(lambda: k2_launch_global(y))
    plain_ms = cuda_time_ms(lambda: plain(*y), 2, 1)
    # cycles a step at the SM clock sampled while the y round runs, else
    # (no sample) at the card's max SM clock, and labelled so
    clock = sm_clock_under_load_ghz(lambda: lane_decode_round(*y))
    clock_src = "sampled under load" if clock else "max SM clock"
    clock = clock or max_clock
    n, k = st.shape
    t_y, t_z = -(-m // k), -(-z[5] // z[0].shape[1])
    cyc = (ms - pro_ms) * 1e-3 * clock * 1e9 / t_y
    cyc_z = (z_ms - pro_z_ms) * 1e-3 * clock * 1e9 / t_z
    bound = k2_bound(st, pt, pt_out, idx, table.cdf_len, max_clock)
    levels = lane_decode_round_lookup(*y, levels=True)[3]
    depth = torch.ceil(torch.log2((table.cdf_len.long()[idx.long()] - 1)
                                  .clamp(min=1).double())).long()
    # v1: the binary search + ~4 dependent loads around it; v2: the bucket
    # search + the lookup and the low / freq loads
    chain_v1 = k2_chain_ms(depth, k, 4, max_clock)
    chain_v2 = k2_chain_ms(levels, k, 2, max_clock)
    print(f"K2 build: registers "
          + ", ".join(f"{e[e.index('ILb'):e.index('ILb') + 5]} "
                      f"{r['registers']}" for e, r in sorted(build.items()))
          + f", no spills; plan y {plan_y}, z {plan_z} [{card}]")
    print(f"K2 y round N{n} K{k} m {m} (table {tuple(table.cdf.shape)}, "
          f"buffer {4 * table.buf.numel()} B): kernel {ms:.4f} ms as a "
          f"CUDA-graph replay (eager {eager_ms:.4f}), prologue (m = 0) "
          f"{pro_ms:.4f} ms, {cyc:.1f} cycles a step over {t_y} steps at "
          f"{clock * 1e3:.0f} MHz ({clock_src}); global-table instantiation "
          f"{glob_ms:.4f} "
          f"ms; plain twin {plain_ms:.4f} ms; bound "
          f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']}: "
          f"{bound['bytes'] / 1e6:.3f} MB, {bound['ops'] / 1e6:.2f} M int "
          f"ops at {bound['int32_rate'] / 1e12:.2f} T/s INT32); chain "
          f"estimates, not measured, at an ASSUMED {SMEM_LATENCY_CYCLES} "
          f"cycles a dependent load and the max SM clock: v1 "
          f"{chain_v1:.4f} ms (binary depth mean "
          f"{bound['mean_search_depth']:.2f}), v2 {chain_v2:.4f} ms (bucket "
          f"levels mean {float(levels.double().mean()):.4f}) [{card}]")
    print(f"K2 z round N{z[0].shape[0]} K{z[0].shape[1]} m {z[5]} (table "
          f"{tuple(z[4].cdf.shape)}, buffer {4 * z[4].buf.numel()} B): "
          f"kernel {z_ms:.4f} ms (eager {z_eager_ms:.4f}), prologue "
          f"{pro_z_ms:.4f} ms, {cyc_z:.1f} cycles a step over {t_z} steps; "
          f"kernel == twin on all {rounds} rounds, bit-stable, a flipped "
          f"word of lane {lane} changes the output [{card}]")
    return dict(ms=ms, eager_ms=eager_ms, z_ms=z_ms, z_eager_ms=z_eager_ms,
                prologue_ms=pro_ms, prologue_z_ms=pro_z_ms,
                global_table_ms=glob_ms, plain_ms=plain_ms,
                max_abs_err=err, cycles_per_step=cyc,
                cycles_per_step_z=cyc_z, cycles_clock_mhz=clock * 1e3,
                cycles_clock=clock_src, registers=regs,
                spill_bytes=sum(r["spill_bytes"] for r in build.values()),
                smem_bytes=plan_y["smem_bytes"],
                smem_bytes_z=plan_z["smem_bytes"],
                shape=f"N{n} K{k} m {m}, y table {tuple(table.cdf.shape)}",
                **bound)


def k3_phase(card: str, ptxas: dict) -> dict:
    """K3 against its twin at the GDN path's shapes, both directions;
    ``ptxas`` is the gdn library's ``ptxas_report``."""
    import torch

    from crdr_tpu_torch.ops.gdn import build as build_gdn
    from crdr_tpu_torch.ops.gdn import gdn, gdn_plain, occupancy

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(99)
    clock = max_sm_clock_ghz()
    f32_rate = (torch.cuda.get_device_properties(0).multi_processor_count
                * FP32_FLOPS_PER_SM_CLOCK * clock * 1e9)
    build = {}  # {(C, vector path, bf16 mode): report} of each instance
    for entry, r in ptxas.items():
        m = re.search(r"gdn_(bf16_)?kernelILi(\d+)ELb([01])E", entry)
        if m:
            build[(int(m.group(2)), m.group(3) == "1",
                   m.group(1) is not None)] = r
    check(len(build) == 16 and all(r["registers"] for r in build.values()),
          f"K3's ptxas report: {ptxas}")
    spills = {k: r["spill_bytes"] for k, r in build.items()
              if r["spill_bytes"]}
    check(not spills, f"K3 spills registers: {spills}")
    occ = occupancy(192)
    occ_bf16 = occupancy(192, bf16=True)
    # the f32 mode runs FFMA: the library's tensor-core instructions are
    # the bf16 mode's
    sass = sass_counts(build_gdn())
    check(sass["HMMA"] + sass["HGMMA"] > 0,
          f"K3's SASS has no tensor-core instruction: {sass}")
    print("K3 build: registers by (C, vector path, mode) "
          + ", ".join(f"{c}{'v' if v else 's'}{'-bf16' if b else ''} "
                      f"{r['registers']}"
                      for (c, v, b), r in sorted(build.items()))
          + f"; no spills; at C 192: {occ['blocks_per_sm']} blocks an SM, "
          f"{occ['tile_pixels']} pixels a block, {occ['smem_bytes']} B of "
          f"shared memory a block (bf16 mode: {occ_bf16['blocks_per_sm']} "
          f"blocks, {occ_bf16['tile_pixels']} pixels a tile, "
          f"{occ_bf16['smem_bytes']} B; its SASS {sass['HMMA']} HMMA / "
          f"{sass['HGMMA']} HGMMA over its 8 instances) [{card}]")

    def excess(out, ref):  # max |out - ref| in units of the tolerance
        return float(((out - ref).abs() / (K3_RTOL * ref.abs() + K3_ATOL))
                     .max())

    rows, bf16_rows = [], []
    for shape in GDN_SHAPES:
        n, c, h, w = shape
        x = torch.randn(shape, device=dev, generator=g)
        beta = torch.empty(c, device=dev).uniform_(0.5, 2.0, generator=g)
        # non-negative and non-symmetric: a transposed read must show
        gamma = torch.empty((c, c), device=dev).uniform_(0.0, 0.1,
                                                         generator=g)
        # yardstick only: cuBLAS's f32 product gamma . x^2 per image
        x2 = (x * x).view(n, c, h * w)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            lib_ms = graph_time_ms(lambda: torch.matmul(gamma, x2))
            lib_eager_ms = cuda_time_ms(lambda: torch.matmul(gamma, x2), 20,
                                        3)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        del x2
        transpose_ms = graph_time_ms(lambda: gamma.t().contiguous())
        for inverse in (False, True):
            tag = f"K3 {list(shape)} {'inverse' if inverse else 'forward'}"
            out = gdn(x, beta, gamma, inverse)
            again = gdn(x, beta, gamma, inverse)
            one = gdn(x[:1].contiguous(), beta, gamma, inverse)
            plain = gdn_plain(x, beta, gamma, inverse)
            torch.cuda.synchronize()
            check(torch.isfinite(out).all(), f"{tag}: non-finite output")
            check(torch.equal(out, again), f"{tag}: two launches differ")
            check(torch.equal(out[:1], one),
                  f"{tag}: image 0 alone != image 0 in the batch of {n}")
            ex = excess(out, plain)
            check(ex <= 1.0, f"{tag}: |kernel - plain| exceeds {K3_RTOL} "
                             f"|plain| + {K3_ATOL} ({ex:.3f}x)")
            # the kernel sums in the twin's order (cuDNN's f32 1x1 conv)
            differing = int((out != plain).sum())
            check(differing == 0, f"{tag}: {differing} elements differ from "
                                  "the twin's bits")
            ex_t = excess(out, gdn_plain(x, beta, gamma.t(), inverse))
            ex_d = excess(out, gdn_plain(x, beta, gamma, not inverse))
            check(min(ex_t, ex_d) > 10,
                  f"{tag}: the check is blind to a transposed gamma "
                  f"({ex_t:.1f}x) or the other direction ({ex_d:.1f}x)")
            diff = (out - plain).abs()
            big = plain.abs() >= 1e-3
            row = dict(shape=list(shape), inverse=inverse, excess=ex,
                       differing=differing, max_abs_err=float(diff.max()),
                       max_rel_err=float((diff[big] / plain.abs()[big])
                                         .max()),
                       library_ms=lib_ms, library_eager_ms=lib_eager_ms,
                       transpose_ms=transpose_ms)
            # device time per call (CUDA graph; the gamma^T copy inside),
            # and the eager call's time with the host's enqueue in it
            row["ms"] = graph_time_ms(lambda: gdn(x, beta, gamma, inverse))
            row["eager_ms"] = cuda_time_ms(
                lambda: gdn(x, beta, gamma, inverse), 20, 3)
            row["plain_ms"] = cuda_time_ms(
                lambda: gdn_plain(x, beta, gamma, inverse), 10, 2)
            m = n * h * w
            flops = 2.0 * m * c * c + 4.0 * m * c  # product + epilogue
            nbytes = 4 * (2 * m * c + c * c + c)
            t_ops, t_bytes = flops / f32_rate, nbytes / H100_BYTES_PER_S
            tiles = -(-h * w // occ["tile_pixels"]) * n
            row.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       gflop=flops / 1e9, mbytes=nbytes / 1e6, blocks=tiles)
            rows.append(row)
            print(f"{tag}: kernel {row['ms']:.4f} ms ("
                  f"{flops / row['ms'] / 1e9:.1f} TFLOP/s; eager, host "
                  f"enqueue included, {row['eager_ms']:.4f} ms; gamma^T copy "
                  f"{transpose_ms:.4f} ms of it), {tiles} blocks, plain "
                  f"{row['plain_ms']:.4f} ms, cuBLAS f32 product "
                  f"{lib_ms:.4f} ms (eager {lib_eager_ms:.4f}), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                  f"{flops / 1e9:.2f} GFLOP at {f32_rate / 1e12:.2f} TFLOP/s "
                  f"f32, {nbytes / 1e6:.1f} MB); {differing} elements differ "
                  f"from the twin, max|err| {row['max_abs_err']:.3e} "
                  f"({ex:.3f}x the tolerance; transposed gamma {ex_t:.0f}x, "
                  f"other direction {ex_d:.0f}x); bit-stable across calls "
                  f"and batch 1 vs {n} [{card}]")
        bf16_rows.extend(k3_bf16_rows(x, beta, gamma, card))
        del x
    total = sum(r["ms"] for r in rows)
    eager = sum(r["eager_ms"] for r in rows)
    bound = sum(r["bound_ms"] for r in rows)
    print(f"K3, the six calls of a GDN round trip: {total:.4f} ms (graph "
          f"replays; eager {eager:.4f} ms) against a bound of {bound:.4f} ms "
          f"[{card}]")
    total16 = sum(r["ms"] for r in bf16_rows)
    bound16 = sum(r["bound_ms"] for r in bf16_rows)
    print(f"K3 bf16 mode, the six calls of a bf16 GDN round trip: "
          f"{total16:.4f} ms (graph replays; eager "
          f"{sum(r['eager_ms'] for r in bf16_rows):.4f} ms) against a bound "
          f"of {bound16:.4f} ms; f32 mode {total:.4f} ms [{card}]")
    r192 = build[(192, True, False)]
    return {"rows": rows, "bf16_rows": bf16_rows,
            "registers": r192["registers"],
            "registers_bf16": build[(192, True, True)]["registers"],
            "spill_bytes": sum(r["spill_bytes"] for r in build.values()),
            "blocks_per_sm_bf16": occ_bf16["blocks_per_sm"],
            "tile_pixels_bf16": occ_bf16["tile_pixels"],
            "smem_bytes_bf16": occ_bf16["smem_bytes"], "sass_bf16": sass,
            **occ}


def bf16_ulps(a, b):
    """|a - b| in bf16 ulps, elementwise (the bit patterns' gap; values of
    one sign)."""
    import torch

    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def k3_bf16_rows(x, beta, gamma, card: str) -> list:
    """K3's bf16 mode at one shape, both directions, on the f32 case's
    inputs rounded to bf16: against the bf16 twin on the card (every
    element the composite of a sum within 1 ulp of the twin's, every later
    step exact; the elements and ulps apart counted), bit-stable across
    calls and batch 1 vs n, blind to neither a transposed gamma; times
    (graph replay and eager), the twin's, cuBLAS's bf16 product gamma . x^2
    (yardstick only) and the bound: bf16 x read and out written, against
    the products at the bf16 tensor-core rate."""
    import torch

    from crdr_tpu_torch.ops.gdn import bf16_unexplained, gdn, gdn_plain

    n, c, h, w = x.shape
    x, beta, gamma = x.bfloat16(), beta.bfloat16(), gamma.bfloat16()
    x2 = (x * x).view(n, c, h * w)
    lib_ms = graph_time_ms(lambda: torch.matmul(gamma, x2))
    del x2
    rows = []
    for inverse in (False, True):
        tag = (f"K3 bf16 {list(x.shape)} "
               f"{'inverse' if inverse else 'forward'}")
        out = gdn(x, beta, gamma, inverse)
        again = gdn(x, beta, gamma, inverse)
        one = gdn(x[:1].contiguous(), beta, gamma, inverse)
        plain = gdn_plain(x, beta, gamma, inverse)
        torch.cuda.synchronize()
        check(out.dtype == torch.bfloat16 and torch.isfinite(out).all(),
              f"{tag}: {out.dtype} output, or non-finite")
        check(torch.equal(out, again), f"{tag}: two launches differ")
        check(torch.equal(out[:1], one),
              f"{tag}: image 0 alone != image 0 in the batch of {n}")
        apart = bf16_ulps(out, plain)
        ulps, differing = int(apart.max()), int((apart > 0).sum())
        unexplained = bf16_unexplained(out, x, beta, gamma, inverse)
        check(unexplained == 0, f"{tag}: {unexplained} elements are no sum "
              f"within 1 ulp of the twin's ({differing} elements, at most "
              f"{ulps} ulps apart from the twin)")
        wrong = bf16_unexplained(out, x, beta, gamma.t(), inverse)
        check(wrong > 0, f"{tag}: the check is blind to a transposed gamma")
        row = dict(shape=list(x.shape), inverse=inverse, ulps=ulps,
                   differing=differing,
                   max_abs_err=float((out.float() - plain.float()).abs()
                                     .max()),
                   library_ms=lib_ms)
        row["ms"] = graph_time_ms(lambda: gdn(x, beta, gamma, inverse))
        row["eager_ms"] = cuda_time_ms(
            lambda: gdn(x, beta, gamma, inverse), 20, 3)
        row["plain_ms"] = cuda_time_ms(
            lambda: gdn_plain(x, beta, gamma, inverse), 10, 2)
        m = n * h * w
        flops = 2.0 * m * c * c + 4.0 * m * c
        nbytes = 2 * (2 * m * c + c * c + c)
        t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        row.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   mbytes=nbytes / 1e6)
        rows.append(row)
        print(f"{tag}: kernel {row['ms']:.4f} ms (eager {row['eager_ms']:.4f}"
              f"), plain {row['plain_ms']:.4f} ms, cuBLAS bf16 product "
              f"{lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP at the bf16 tensor-core rate); "
              f"{differing} of {out.numel()} elements apart from the bf16 "
              f"twin, at most {ulps} ulp, each a sum within 1 ulp of the "
              f"twin's (transposed gamma: {wrong} elements no such sum); "
              f"bit-stable across calls and batch 1 vs {n} [{card}]")
    return rows


def deconv_phase(model, card: str) -> list:
    """A yardstick only (the port's synthesis is unchanged): one
    ConvTranspose2d of the Balle18 decoder at two path shapes, as the port
    runs it (cuDNN, codec numerics) and as four stride-1 sub-pixel
    convolutions in one conv plus pixel_shuffle, held within f32 tolerance
    of the first."""
    import torch
    import torch.nn.functional as F

    from crdr_tpu_torch.models.codec import codec_numerics
    from crdr_tpu_torch.nn.conv import subpixel_weight

    g = torch.Generator(device=model.device).manual_seed(17)
    rows = []
    dec = model.net.decoder
    for name, (h, w) in (("conv_2", (IMG_H // 8, IMG_W // 8)),
                         ("conv_4", (IMG_H // 4, IMG_W // 4))):
        conv = getattr(dec, name)
        x = torch.randn((N_IMG, conv.weight.shape[0], h, w),
                        device=model.device, generator=g)
        with codec_numerics():
            w4 = subpixel_weight(conv.weight, 2, 2)
            b4 = conv.bias.repeat_interleave(4)
            ref = conv(x)
            sub = F.pixel_shuffle(F.conv2d(x, w4, b4, padding=1), 2)
            torch.cuda.synchronize()
            err = float((ref - sub).abs().max())
            scale = float(ref.abs().max())
            check(err <= 1e-5 * scale + 1e-6,
                  f"sub-pixel {name}: max|diff| {err:.3e} of {scale:.3e}")
            port_ms = cuda_time_ms(lambda: conv(x), 10, 2)
            sub_ms = cuda_time_ms(lambda: F.pixel_shuffle(
                F.conv2d(x, w4, b4, padding=1), 2), 10, 2)
        rows.append(dict(layer=name, shape=list(x.shape), port_ms=port_ms,
                         subpixel_ms=sub_ms, max_abs_diff=err))
        print(f"GDN synthesis {name} {list(x.shape)} -> "
              f"{list(ref.shape[2:])}: ConvTranspose2d as the port runs it "
              f"{port_ms:.4f} ms, as sub-pixel conv + pixel_shuffle "
              f"{sub_ms:.4f} ms (max|diff| {err:.3e} of |out| <= "
              f"{scale:.3f}); codec numerics, yardstick only [{card}]")
    return rows


def build_gdn_model(imgs, card: str):
    """The GDN path's model: seeded init, then the edits of the module
    doc (phase 7)."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.nn import GDN, NonNegativeParam
    from crdr_tpu_torch.utils.config import Config

    cfg = Config.from_file(os.path.join(ROOT, "config",
                                        "balle18_mean_scale.yaml"))
    t0 = time.perf_counter()
    model = build_comp_model(cfg)  # the GPU; seeded init (cfg seed / 0)
    net = model.net
    g = torch.Generator(device=model.device).manual_seed(4321)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, GDN):  # about the init's weight, spread out
                c = m.gamma.shape[0]
                m.gamma.copy_(NonNegativeParam().init(torch.empty_like(
                    m.gamma).uniform_(0.0, 2.0 / c, generator=g)))
        # at the random init y sits within a bin of 0; a gain on the last
        # analysis conv spreads it over ~Y_STD bins, and the scale half of
        # the hyper-decoder's bias makes the y tables carry that rate
        x = torch.from_numpy(imgs[:1]).to(model.device)
        x = ((x.float() / 255.0 - 0.5) * 2.0).permute(0, 3, 1, 2)
        gain = Y_STD / float(net.encoder(x.contiguous()).std())
        net.encoder.conv_6.weight.mul_(gain)
        net.encoder.conv_6.bias.mul_(gain)
        half = net.hyperdecoder.c3.bias.numel() // 2
        net.hyperdecoder.c3.bias[half:] += Y_STD
    model.codec_setup()
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in net.parameters())
    print(f"GDN path {cfg.model_type} (Balle18, mean-scale): "
          f"{nparam / 1e6:.1f}M params, analysis gain {gain:.2f}, built in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return model


@contextlib.contextmanager
def k3_call_dtypes():
    """Within the block, the dtype of x at each GDN layer's K3 call
    (``nn.norm``'s ``gdn``), in call order."""
    from crdr_tpu_torch.nn import norm

    real, dtypes = norm.gdn, []

    def spy(x, *args):
        dtypes.append(x.dtype)
        return real(x, *args)

    norm.gdn = spy
    try:
        yield dtypes
    finally:
        norm.gdn = real


def psnr_of(imgs, fake) -> float:
    from crdr_tpu_torch.utils.img_utils import calc_psnr, uint8_to_tensor

    return calc_psnr(uint8_to_tensor(imgs), fake)


def bf16_round_trip(model, imgs, label: str, expected: dict,
                    card: str) -> dict:
    """One batch round trip of a GDN model at ``transform_dtype: bfloat16``
    (set in its options, codec_setup again), on the wire its options name:
    the launches ``expected`` with every K3 call on bf16, and the checks of
    phase 3 (decoded y_hat == the encoder's, real vs predicted bpp); its
    PSNR and (cold) times."""
    import torch

    model.opt["transform_dtype"] = "bfloat16"
    model.codec_setup()
    check(model.transform_dtype == torch.bfloat16,
          f"{label}: transform_dtype is {model.transform_dtype}")
    expected = {"lane_encode_rounds": 0, **expected}
    with k3_call_dtypes() as dtypes:
        encs, (fake, _, y_hat), enc_s, dec_s, counts = \
            counted_round_trip(model, imgs)
    check(counts == expected, f"{label}: kernel launches in one batch round "
                              f"trip {counts} (expected {expected})")
    check(dtypes == [torch.bfloat16] * expected["gdn"],
          f"{label}: K3 called on {dtypes}")
    check_round_trip(label, encs, fake, y_hat)
    res = {"launches": counts, "psnr": psnr_of(imgs, fake),
           "encode_ms": enc_s * 1e3, "decode_ms": dec_s * 1e3}
    print(f"{label}: one batch round trip (cold) encode "
          f"{res['encode_ms']:.1f} ms, decode {res['decode_ms']:.1f} ms, "
          f"PSNR {res['psnr']:.3f} dB, launches {counts}, every K3 call on "
          f"bf16; decoded y_hat == the encoder's [{card}]")
    return res


def gdn_bf16_phase(model, imgs, encs_f32, card: str) -> dict:
    """Phase 7's bf16 half: the GDN path's model at transform_dtype
    bfloat16, one round trip on the compressai wire and one on the device
    wire (E1), 6 K3 launches each, all bf16; the PSNR beside the f32
    path's (phase 7's streams decoded at f32)."""
    fake, _, _ = model.decompress_batch([e["string_list"] for e in encs_f32])
    res = {"f32_psnr": psnr_of(imgs, fake)}
    res["compressai"] = bf16_round_trip(
        model, imgs, "GDN path bf16 compressai",
        {"slice_transform": 0, "lane_decode_round": 0, "gdn": 6}, card)
    model.opt.update(wire_format="device", device_wire_encoder="device")
    res["device"] = bf16_round_trip(
        model, imgs, "GDN path bf16 device wire",
        device_wire_expected(model, "device", gdn=6), card)
    print(f"GDN path PSNR: f32 {res['f32_psnr']:.3f} dB, bf16 compressai "
          f"{res['compressai']['psnr']:.3f} dB, bf16 device wire "
          f"{res['device']['psnr']:.3f} dB [{card}]")
    return res


def encode_ab_phase(model, imgs, card: str, pairs: int = 6) -> None:
    """Where image 0 of a batch-1 and a batch-4 analysis first differ with
    the whole-batch analysis (A), then A against the fixed-batch analysis
    (B), alternating A B B A, on the compressai wire."""
    import torch

    from crdr_tpu_torch.models.codec import _tf32, codec_numerics

    def whole_batch(x, rate_ind):  # A: one analysis call over the batch
        with _tf32(model._transform_tf32):
            return model.net.encode_latents(x, rate_ind, model._enc_t,
                                            model._henc_t)

    def use(variant):  # A shadows the method on the instance; B is the method
        if variant == "A":
            model._analysis = whole_batch
        else:
            model.__dict__.pop("_analysis", None)

    x = torch.from_numpy(imgs).to(model.device)
    mods = [(f"{tag}.{n}", mod) for tag, net in (("encoder", model._enc_t),
                                                 ("hyperencoder",
                                                  model._henc_t))
            for n, mod in net.named_modules() if not list(mod.children())]
    res = {"A": ([], [], []), "B": ([], [], [])}
    try:
        for variant in res:
            use(variant)
            calls = []  # per pass: (layer, image 0's output) in call order
            hooks = [mod.register_forward_hook(
                lambda _m, _i, o, name=name: calls[-1].append(
                    (name, o[:1].float().clone())) if torch.is_tensor(o)
                else None) for name, mod in mods]
            try:
                for xb in (x, x[:1]):
                    calls.append([])
                    with codec_numerics():
                        model.encode_head(xb, model._cond_arg(RATE, len(xb)))
            finally:
                for h in hooks:
                    h.remove()
            first = next(((name, float((a - b).abs().max()))
                          for (name, a), (_, b) in zip(*calls)
                          if not torch.equal(a, b)), None)
            label = "whole batch" if variant == "A" else "fixed batch 4"
            print(f"analysis ({label}): first of {len(calls[0])} layer calls "
                  f"where image 0 differs between a batch-1 and a "
                  f"batch-{N_IMG} call: {first or 'none'} [{card}]")
            check(variant == "A" or first is None,
                  f"fixed-batch analysis: image 0 differs at {first}")

        for variant in res:  # warm both up at both batch sizes
            use(variant)
            model.compress_batch(imgs, rate_ind=RATE)
            model.compress(imgs[:1], rate_ind=RATE)
        for _ in range(pairs):
            for variant in ("A", "B", "B", "A"):
                use(variant)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = model.compress_batch(imgs, rate_ind=RATE)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                one = model.compress(imgs[:1], rate_ind=RATE)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                res[variant][0].append((t1 - t0) * 1e3)
                res[variant][1].append((t2 - t1) * 1e3)
                res[variant][2].append(one["string_list"] ==
                                       batch[0]["string_list"])
    finally:
        use("B")
    for variant, (b4, b1, same) in res.items():
        print(f"encode A/B {variant} ("
              f"{'whole batch' if variant == 'A' else 'fixed batch 4'}), "
              f"{2 * pairs} runs in A B B A order: batch-{N_IMG} median "
              f"{np.median(b4):.1f} ms ({min(b4):.1f}-{max(b4):.1f}), batch-1 "
              f"median {np.median(b1):.1f} ms ({min(b1):.1f}-{max(b1):.1f}); "
              f"batch-1 stream of image 0 == batch-{N_IMG}: {sum(same)} of "
              f"{len(same)} [{card}]")


# the five model configs besides the flagship's (config/_base_/model/)
CLASS_CONFIGS = ("elic_hyperprior", "elic_charm", "interp_ca_elic_hyperprior",
                 "interp_ca_elic_charm", "beta_cond_interp_ca_elic_hyperprior")
# the codec options of config/crdr_throughput.yaml (and crdr.yaml under it)
THROUGHPUT_OPTIONS = ("codec_uint8_io", "transform_precision",
                      "transform_dtype", "fused_slice_kernel",
                      "fused_decode_loop")
TF32_REL = 1e-2      # fastchain vs highest hyper-decoder, max |diff| / max |ref|
BPP_AGREE = 1e-3     # validation (batch 1) vs run_model (batch 4) bpp


def class_model(name: str, card: str):
    """A model config at full width with crdr_throughput.yaml's codec
    options laid over it; seeded init, y scales raised."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import Config

    cfg = Config.from_file(os.path.join(ROOT, "config", "_base_", "model",
                                        f"{name}.yaml"))
    served = Config.from_file(os.path.join(ROOT, "config",
                                           "crdr_throughput.yaml"))
    for key in THROUGHPUT_OPTIONS:
        cfg[key] = served[key]
    t0 = time.perf_counter()
    model = build_comp_model(cfg)
    raise_y_scales(model)
    model.codec_setup()
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in model.net.parameters())
    print(f"{name} ({cfg.model_type}): {nparam / 1e6:.1f}M params, "
          f"fused_slice_kernel={model.fused_slice_kernel}, built in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return model


def model_class_phase(imgs, card: str):
    """Each of CLASS_CONFIGS on the compressai wire (K1 60 a round trip on
    the Charm classes, none on the others), interp_ca_elic_charm also on the
    device wire (K2 11); the checks and times of host_wire_path /
    device_wire_path.  Returns ({path: launches}, {path: times})."""
    import torch

    counts, times = {}, {}
    for name in CLASS_CONFIGS:
        model = class_model(name, card)
        k1 = 6 * model.num_slices if model.use_charm else 0
        encs, counts[name], times[name] = host_wire_path(
            model, imgs, name,
            {"slice_transform": k1, "lane_decode_round": 0, "gdn": 0}, card,
            runs=SIDE_RUNS, padding=False)
        if name == "interp_ca_elic_charm":
            y_c = np.concatenate([e["y_hat"] for e in encs])
            label = f"{name} device wire"
            _, counts[label], times[label], _ = device_wire_path(
                model, imgs, y_c, card, label, runs=SIDE_RUNS)
        del model, encs
        torch.cuda.empty_cache()
    return counts, times


def tf32_chain_phase(imgs, card: str):
    """config/crdr_fastchain.yaml (codec_precision: default: TF32 in the
    hyper-decoder and, with K1 off, in every Charm conv) on the flagship,
    K1 on and off, each on both wires with the checks of host_wire_path /
    device_wire_path; then, on each wire, the times of crdr_throughput.yaml
    and of both variants in turns (A B C C B A, TIMED_RUNS round trips
    each).  Returns ({path: launches}, {variant: TF32 max |diff|})."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.models.codec import codec_numerics
    from crdr_tpu_torch.utils.config import Config

    counts, diffs, models = {}, {}, {"crdr_throughput": build_model(card)}
    for fused in (True, False):
        cfg = Config.from_file(os.path.join(ROOT, "config",
                                            "crdr_fastchain.yaml"))
        cfg["fused_slice_kernel"] = fused
        model = build_comp_model(cfg)
        raise_y_scales(model)
        model.codec_setup()
        check(model._chain_tf32 and model.fused_slice_kernel == fused,
              "crdr_fastchain.yaml must set codec_precision: default")
        tag = f"fastchain K1 {'on' if fused else 'off'}"
        k1 = 6 * model.num_slices if fused else 0
        encs, counts[tag], _ = host_wire_path(
            model, imgs, tag,
            {"slice_transform": k1, "lane_decode_round": 0, "gdn": 0}, card,
            runs=SIDE_RUNS, padding=False)

        # TF32 really ran: the hyper-decoder on one z_sym, f32 vs TF32
        with codec_numerics(False):
            x = torch.from_numpy(imgs[:1]).to(model.device)
            _, z_sym, _ = model.encode_head(x, model._cond_arg(RATE, 1))
            ref = torch.cat(model._hyper_decode(z_sym)[0], -1)
        with codec_numerics(True):
            tf = torch.cat(model._hyper_decode(z_sym)[0], -1)
        diff = float((tf - ref).abs().max())
        scale = float(ref.abs().max())
        diffs[tag] = diff
        print(f"{tag}: hyper-decoder output under TF32 vs f32 on one z: "
              f"max |diff| {diff:.3e} of max |out| {scale:.3f} "
              f"({diff / scale:.2e} relative) [{card}]")
        check(0 < diff <= TF32_REL * scale,
              f"{tag}: TF32 changed the hyper-decoder by {diff} (must be > 0 "
              f"and <= {TF32_REL} x {scale})")

        y_c = np.concatenate([e["y_hat"] for e in encs])
        label = f"{tag} device wire"
        _, counts[label], _, _ = device_wire_path(model, imgs, y_c, card,
                                                  label, runs=SIDE_RUNS)
        models[tag] = model
        del encs

    mpix = N_IMG * IMG_H * IMG_W / 1e6
    for wire in ("compressai", "device"):
        for model in models.values():
            model.opt.update(wire_format=wire, device_wire_encoder="host")
            model.codec_setup()
        runs = {name: ([], []) for name in models}
        for name in list(models) + list(models)[::-1]:
            t = timed_runs(models[name], imgs, f"{name} {wire} wire, in turns",
                           card)
            runs[name][0].extend(t["encode_runs_ms"])
            runs[name][1].extend(t["decode_runs_ms"])
        for name, (enc, dec) in runs.items():
            e, d = float(np.median(enc)), float(np.median(dec))
            print(f"TF32 chain, {wire} wire, batch {N_IMG}, median of "
                  f"{len(enc)} in turns (A B C C B A): {name}: encode "
                  f"{e:.1f} ms, decode {d:.1f} ms, "
                  f"{mpix / (e + d) * 1e3:.4f} Mpix/s (decode runs "
                  f"{[round(v, 1) for v in dec]}) [{card}]")
    del models
    torch.cuda.empty_cache()
    return counts, diffs


def spread_rates(model) -> None:
    """At the random init every InterpCA gain is 1 at every rate, so the
    rate changes nothing; give the encoder's last InterpCA gains 2^q
    (softplus^-1 of them), so y, and with it the bpp, grows with the rate
    (at gains below 1 the init's y rounds to 0 everywhere)."""
    import torch

    ca = model.net.encoder.interp_ca_list[-1]
    with torch.no_grad():
        for q in range(ca.weight.shape[0]):
            gain = torch.tensor(2.0 ** q)
            ca.weight[q] = torch.log(torch.expm1(gain))


def entry_point_phase(imgs, card: str) -> dict:
    """run_model / validation on the flagship at every rate, then the CLI
    as a subprocess on each wire, held against compress_batch /
    decompress_batch.  Returns {path: launches} of the in-process calls."""
    import tempfile

    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.models.codec import device_uint8_to_tensor
    from crdr_tpu_torch.utils import codec_utils
    from crdr_tpu_torch.utils.config import Config
    from crdr_tpu_torch.utils.img_utils import (calc_ms_ssim, calc_psnr,
                                                imread, read_png,
                                                tensor_to_uint8,
                                                uint8_to_tensor, write_png)

    cfg_path = os.path.join(ROOT, "config", "crdr_throughput.yaml")
    model = build_comp_model(Config.from_file(cfg_path))
    spread_rates(model)

    # the codec's on-device uint8 conversion (encode_head) is the host's
    # uint8_to_tensor, bit for bit; a CPU-scalar divisor would not be
    # (CUDA divides by one as a multiply by its f32 reciprocal)
    v = torch.arange(256, dtype=torch.uint8, device=model.device)
    host = torch.from_numpy(uint8_to_tensor(np.arange(256, dtype=np.uint8)))
    scalar = ((v.float() / 255.0 - 0.5) * 2.0).cpu()
    exact = device_uint8_to_tensor(v).cpu()
    print(f"uint8 -> f32 on the card: a CPU-scalar divisor differs from the "
          f"host's uint8_to_tensor in {int((scalar != host).sum())} of 256 "
          f"values, the codec's device-tensor divisor in "
          f"{int((exact != host).sum())} [{card}]")
    check(torch.equal(exact, host), "the codec's uint8 conversion is not "
                                    "the host's")
    x = uint8_to_tensor(imgs)
    beta = model.max_beta / 2
    counts = {}
    kernels = kernel_wrappers()
    for k in kernels.values():
        k.launches = 0
    by_rate = []
    for q in range(model.rate_level):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.run_model(x, rate_ind=float(q), beta=beta, is_train=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        psnr = calc_psnr(out["real_images"], out["fake_images"])
        msssim = calc_ms_ssim(out["real_images"], out["fake_images"])
        by_rate.append(out["bpp"])
        print(f"run_model rate {q} beta {beta}: bpp {np.round(out['bpp'], 4)}"
              f" (mean {out['bpp'].mean():.4f}, qbpp "
              f"{out['qbpp'].mean():.4f}), PSNR {psnr:.3f} dB, MS-SSIM "
              f"{msssim:.5f}; {dt * 1e3:.1f} ms for {N_IMG} images [{card}]")
        check(np.isfinite(out["bpp"]).all() and np.isfinite(psnr)
              and np.isfinite(msssim) and 0 < msssim <= 1,
              f"run_model rate {q}: non-finite metrics")
    counts["run_model"] = {n: k.launches for n, k in kernels.items()}
    means = [float(b.mean()) for b in by_rate]
    check(all(a < b for a, b in zip(means, means[1:])),
          f"run_model: bpp does not rise with the rate: {means}")

    t0 = time.perf_counter()
    rows = model.validation([{"real_images": x[i:i + 1]}
                             for i in range(N_IMG)])
    torch.cuda.synchronize()
    print(f"validation: {len(rows)} images x {model.rate_level} rates in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    check(len(rows) == N_IMG, f"validation gave {len(rows)} rows")
    for row in rows:
        print("validation row " + json.dumps(
            {k: round(v, 5) for k, v in row.items()}))
        for q in range(model.rate_level):
            bpp = row[f"bpp_{q + 1}"]
            check(np.isfinite([bpp, row[f"psnr_{q + 1}"],
                               row[f"ms_ssim_{q + 1}"]]).all(),
                  f"validation row {row['idx']}: non-finite metrics")
            want = float(by_rate[q][row["idx"] - 1])
            check(abs(bpp - want) <= BPP_AGREE * want,
                  f"validation bpp_{q + 1} of image {row['idx']}: {bpp} vs "
                  f"run_model's {want}")
    del model
    torch.cuda.empty_cache()

    # the CLI, as a user runs it: crdr_throughput.yaml, seeded init
    model = build_comp_model(Config.from_file(cfg_path))
    model.codec_setup()
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        img_dir = os.path.join(tmp, "img")
        names = [f"img{i}" for i in range(N_IMG)]
        for name, img in zip(names, imgs):
            write_png(os.path.join(img_dir, f"{name}.png"), img)
        refs = {}  # this process's streams and images of the PNGs
        for wire in ("compressai", "device"):
            if wire == "device":
                model.opt.update(wire_format="device",
                                 device_wire_encoder="host")
                model.codec_setup()
            floats = np.stack([imread(os.path.join(img_dir, f"{n}.png"))
                               for n in names])
            for k in kernels.values():
                k.launches = 0
            encs = model.compress_batch(floats, rate_ind=RATE)
            fake, _, _ = model.decompress_batch(
                [e["string_list"] for e in encs], beta=BETA)
            counts[f"cli check {wire}"] = {n: k.launches
                                           for n, k in kernels.items()}
            check(all(e["string_list"] == u["string_list"] for e, u in
                      zip(encs, model.compress_batch(imgs, rate_ind=RATE))),
                  f"{wire}: the float and the uint8 input give other streams")
            refs[wire] = encs, fake
        procs = {}  # both wires' CLI processes at once
        for wire in ("compressai", "device"):
            cmd = [sys.executable, "-m", "crdr_tpu_torch.cli.compress",
                   "config/crdr_throughput.yaml", "--img_dir", img_dir,
                   "--save_dir", os.path.join(tmp, wire), "-q", str(RATE),
                   "-b", str(BETA), "--decompress", "--batch", str(N_IMG)]
            if wire == "device":
                cmd += ["--wire", "device"]
            procs[wire] = start_proc(cmd, ROOT,
                                     os.path.join(tmp, f"{wire}.log"))
        for wire in ("compressai", "device"):
            (encs, fake), cmd = refs[wire], procs[wire]["cmd"]
            out = os.path.join(tmp, wire)
            rc, log, dt = end_proc(procs[wire])
            check(rc == 0, f"the CLI ({wire}) exited {rc}:\n{log[-6000:]}")
            print(f"CLI {wire} wire: {' '.join(cmd[1:])} ran in {dt:.1f} s "
                  f"(process start, model build and codec setup included; "
                  f"both wires' CLIs at once) [{card}]")
            with open(os.path.join(out, "_bitrates.csv")) as f:
                print(f.read().strip())
            real = []
            for name, enc, img in zip(names, encs, fake):
                got = codec_utils.load_byte_strings(
                    os.path.join(out, f"{name}.bin"))
                check(got == enc["string_list"],
                      f"CLI {wire}: {name}.bin != compress_batch's streams")
                size = len(codec_utils.pack_byte_strings(enc["string_list"]))
                real.append(size * 8 / (IMG_H * IMG_W))
                check(np.array_equal(read_png(os.path.join(
                    out, f"{name}.png")), tensor_to_uint8(img)),
                    f"CLI {wire}: {name}.png != decompress_batch's image")
            with open(os.path.join(out, "_avg_bitrate.json")) as f:
                avg = json.load(f)["avg_bpp"]
            check(avg == float(np.mean(real)), f"CLI {wire}: avg_bpp {avg} "
                  f"!= compress_batch's mean real bpp {np.mean(real)}")
            print(f"CLI {wire} wire: {N_IMG} .bin equal to compress_batch's "
                  f"streams, {N_IMG} .png equal to decompress_batch's "
                  f"images, avg_bpp {avg:.6f} == their mean real bpp")
    del model
    torch.cuda.empty_cache()
    return counts


# ---------------- phases 11-14: the device encoder (E1), the checkerboard,
# the generic device wire ------------------------------------------------------

Y_STD_ESCAPES = 20.0  # phase 11: y's spread in bins for the escape run
STEP_CHAIN_INSTR = 10  # E1 v2's chain estimate: dependent integer
#                        instructions a step (the renorm test and select,
#                        the reciprocal's multiplies, adds and shift, the
#                        update), an ASSUMED count (v1's division: ~25)
INT_LATENCY_CYCLES = 4  # an ASSUMED latency of one dependent integer
#                         instruction on Hopper, not measured
E1_V1_CYCLES = 414.2  # E1 v1's cycles a step on the flagship's y call
#                       (time x the SM clock / T), as PERF.md records it
#                       (PR 18, run D): printed as the "before", not measured


def record_e1(model, fn):
    """Runs ``fn()`` with E1's wrapper recorded where the codec calls it;
    returns the calls' argument tuples (tensors cloned)."""
    import torch

    from crdr_tpu_torch.models import codec_devicewire

    real, calls = codec_devicewire.lane_encode_rounds, []

    def recorder(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return real(*args)

    codec_devicewire.lane_encode_rounds = recorder
    try:
        fn()
    finally:
        codec_devicewire.lane_encode_rounds = real
    return calls


def encoders_in_turns(model, imgs, label: str, card: str) -> dict:
    """Batch encode ms with the device encoder (E1) and the host lane coder,
    in turns (A B B A, TIMED_RUNS each): medians by encoder."""
    import torch

    runs = {"device": [], "host": []}
    for enc in ("device", "host", "host", "device"):
        model.opt.update(device_wire_encoder=enc)
        model.codec_setup()
        model.compress_batch(imgs, rate_ind=RATE)  # warm-up
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.compress_batch(imgs, rate_ind=RATE)
            torch.cuda.synchronize()
            runs[enc].append((time.perf_counter() - t0) * 1e3)
    med = {e: float(np.median(r)) for e, r in runs.items()}
    print(f"{label} encode, batch {N_IMG}, median of {2 * TIMED_RUNS} in "
          f"turns (A B B A): device encoder {med['device']:.1f} ms, host "
          f"encoder {med['host']:.1f} ms (runs device "
          f"{[round(v, 1) for v in runs['device']]}, host "
          f"{[round(v, 1) for v in runs['host']]}) [{card}]")
    return med


def n_fixups(container: bytes) -> int:
    """The fixup count of a lane container (u16 after the magic and K)."""
    return int(np.frombuffer(container, np.uint16, 1, 7)[0])


def flagship_device_encoder_phase(imgs, host_streams, card: str):
    """Phase 11: the flagship on the device wire with the device encoder:
    the checks of phase 4 (K1 60, K2 11, E1 2 a round trip), streams equal
    to phase 4's host-encoder streams, the encode timed in turns with the
    host encoder; then y spread by an analysis gain until symbols leave
    their CDF rows, with a fixup cap of half the fewest escapes an image
    has: E1 keeps every escape and gives the host coder's bytes without
    calling it.  Returns (E1's recorded calls, those of the escape run, the
    cap, the lane statics, counts, encode medians)."""
    import torch

    from crdr_tpu_torch.models import codec_devicewire
    from crdr_tpu_torch.models.codec import codec_numerics

    model = build_model(card)
    y_c = np.concatenate([e["y_hat"] for e in model.compress_batch(
        imgs, rate_ind=RATE)])
    _, counts, times, encs = device_wire_path(
        model, imgs, y_c, card, "flagship device encoder", encoder="device")
    check([e["string_list"] for e in encs] == host_streams,
          "flagship: the device encoder's streams != phase 4's host-encoder "
          "streams")
    print("flagship device encoder: streams byte-equal to phase 4's host "
          "encoder")
    recorded = record_e1(model, lambda: model.compress_batch(
        imgs, rate_ind=RATE))
    check(len(recorded) == 2, f"E1 calls in one encode: {len(recorded)}")
    st = model._lane_wire_statics(IMG_H // 16, IMG_W // 16, IMG_H // 64,
                                  IMG_W // 64)
    med = encoders_in_turns(model, imgs, "flagship device wire", card)

    # escapes: at the random init y rounds to 0 around its mean, so no
    # symbol leaves its CDF row; a gain on the last analysis conv spreads y
    # over ~Y_STD_ESCAPES bins, past the rows' ends (~6 sigma) for a share
    # of the symbols
    with codec_numerics(model._chain_tf32):
        y = model.encode_head(torch.from_numpy(imgs).to(model.device),
                              model._cond_arg(RATE, N_IMG))[0]
    gain = Y_STD_ESCAPES / float(y.std())
    with torch.no_grad():
        model.net.encoder.conv4.weight.mul_(gain)
        model.net.encoder.conv4.bias.mul_(gain)
    model.opt.update(device_wire_encoder="device",
                     device_wire_fixup_cap=1 << 16)
    model.codec_setup()
    probe = model.compress_batch(imgs, rate_ind=RATE)
    fixups = [n_fixups(e["string_list"][2]) for e in probe]
    check(0 < min(fixups) and max(fixups) < 60000,
          f"analysis gain {gain:.2f}: y fixups an image {fixups} (expected "
          "some, and fewer than a container holds)")
    cap = max(1, min(fixups) // 2)
    model.opt.update(device_wire_fixup_cap=cap)
    model.codec_setup()
    host_coder = codec_devicewire.lane_encode

    def refuse(*_):
        raise AssertionError("the device encoder called the host coder")

    codec_devicewire.lane_encode = refuse
    try:
        esc_calls = record_e1(model, lambda: model.compress_batch(
            imgs, rate_ind=RATE))
        dev = model.compress_batch(imgs, rate_ind=RATE)
    finally:
        codec_devicewire.lane_encode = host_coder
    model.opt.update(device_wire_encoder="host")
    model.codec_setup()
    host = model.compress_batch(imgs, rate_ind=RATE)
    check([e["string_list"] for e in dev] == [e["string_list"] for e in host]
          and [e["string_list"] for e in probe] == [e["string_list"]
                                                    for e in host],
          "E1's bytes past the fixup cap != the host encoder's")
    _, _, y_hat = model.decompress_batch([e["string_list"] for e in dev],
                                         beta=BETA)
    check(np.array_equal(y_hat, np.concatenate([e["y_hat"] for e in dev])),
          "the escape streams do not decode to the encoder's y_hat")
    print(f"escapes (analysis gain {gain:.2f}): {fixups} y fixups an "
          f"image, fixup cap {cap}: E1 kept every escape, the host coder "
          "was not called, the streams equal the host encoder's at this "
          "cap and at 65536; decoded exactly")
    del model
    torch.cuda.empty_cache()
    return recorded, esc_calls, cap, st, counts, med


def e1_lane_order(args) -> tuple:
    """A recorded call of E1's wrapper in the twin's lane-order form (JAX's
    arguments): the symbols and rows int32, permuted into lane order when
    the call carries the codec's ``perm``."""
    import torch

    sym, idx = args[0].to(torch.int32), args[1]
    idx = idx.expand(sym.shape[0], -1).to(torch.int32)
    perm = args[7] if len(args) > 7 else None
    if perm is not None:
        sym, idx = sym.index_select(1, perm), idx.index_select(1, perm)
    return (sym, idx) + tuple(args[2:7])


def e1_op_args(args) -> tuple:
    """The arguments E1's wrapper hands its op (``crdr::lane_encode``) on a
    recorded codec call (the codec passes ``pos`` and ``etab``)."""
    import torch

    sym, idx, grid, _cdf, cdf_len, offset, _cap, _perm, pos, etab = args
    return (sym.to(torch.int32), idx.to(torch.int32), grid, pos, etab,
            cdf_len, offset)


def e1_bound(op_args, n_esc, clock_ghz: float) -> dict:
    """Bytes / operations of the function E1's wrapper computes on these
    inputs: the symbols, their rows (once when broadcast), the grid and the
    positions, the dense CDF table (R x L int32) and its row headers read
    once; the words, the lengths and this call's ``n_esc`` [N] escapes'
    fixups (position and value) with their counts written once; ~30
    integer operations an active entry (the slot, the renorm test and
    shift, the reciprocal's division, the update).  The op's 16-byte
    table entries and per-symbol escape flags belong to its design, not to
    the function, and are not counted."""
    import torch

    sym, idx, grid, pos, etab, cdf_len, _ = op_args
    n, m = sym.shape
    t_steps, k = grid.shape
    rows, big_l = etab.shape[:2]
    idx_rows = idx.shape[0] if idx.stride(0) else 1
    fixups = int(n_esc.sum())
    active = n * int((grid >= 0).sum())
    nbytes = (4 * n * m + 4 * idx_rows * m + 4 * 2 * t_steps * k
              + 4 * rows * big_l + 4 * 2 * cdf_len.numel()
              + 4 * n * k * (t_steps + 2) + 4 * n * k
              + 4 * 2 * fixups + 4 * n)
    ops = 30 * active
    int32_rate = (torch.cuda.get_device_properties(0).multi_processor_count
                  * INT32_LANES_PER_SM * clock_ghz * 1e9)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / int32_rate
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, int32_rate=int32_rate)


def e1_phase(recorded, esc_calls, cap, st, card: str, ptxas: dict) -> dict:
    """Phase 12: E1 against its twin and the host coder on the flagship's
    recorded calls (y: 10 rounds, K 128, T 3,840, read where the codec
    produced it through ``pos``; z: one round of 18,432): the wrapper ==
    twin element for element, containers byte-equal to the host coder's, a
    flipped symbol changes the output, two launches bit-identical; on the
    escape run's y call every escape, more than the codec's ``cap``, is
    stored and equals the host coder's, and at a fix_cap of ``cap`` the
    escapes past it are counted; registers and spills; times, cycles a step
    (v1's as PERF.md records it, ``E1_V1_CYCLES``) and the bound."""
    import torch

    from crdr_tpu_torch.ops import device_rans
    from crdr_tpu_torch.ops.lane_encode import launch_walk, lane_encode_rounds
    from crdr_tpu_torch.runtime.lane_rans import (lane_encode,
                                                  pack_lane_container)

    offs = (st.off, np.asarray([0, recorded[1][0].shape[1]], np.int64))
    host_ms, err, y_esc = [], 0, None
    for args, off, name in zip(recorded, offs, ("y", "z")):
        got = lane_encode_rounds(*args)
        again = lane_encode_rounds(*args)
        twin = device_rans.lane_encode_rounds(*args[:8])  # to perm
        torch.cuda.synchronize()
        for a, b, c, part in zip(got, again, twin, ("words", "lens",
                                                    "fix_pos", "fix_val",
                                                    "n_esc")):
            check(torch.equal(a, b), f"E1 {name}: two launches differ in "
                                     f"{part}")
            check(torch.equal(a, c), f"E1 {name}: kernel != twin in {part}")
            if a.numel():
                err = max(err, int((a.long() - c.long()).abs().max()))
        if y_esc is None:
            y_esc = got[4]
        lane = e1_lane_order(args)
        sym, idx = lane[0].cpu().numpy(), lane[1].cpu().numpy()
        tabs = [a.cpu().numpy() for a in args[3:6]]
        k = args[2].shape[1]
        words, lens, fp, fv, ne = (a.cpu().numpy() for a in got)
        t0 = time.perf_counter()
        hosts = [lane_encode(sym[b], idx[b], off, k, *tabs)
                 for b in range(sym.shape[0])]
        host_ms.append((time.perf_counter() - t0) * 1e3)
        for b, host in enumerate(hosts):
            f = int(ne[b])
            check(pack_lane_container(
                words[b].astype(np.uint16), lens[b],
                fp[b, :f].astype(np.int64), fv[b, :f])
                == pack_lane_container(*host),
                f"E1 {name} image {b}: container != the host coder's")
        print(f"E1 {name}: N{sym.shape[0]} K{k} T{args[2].shape[0]} m "
              f"{sym.shape[1]}: kernel == twin (words, lens, fixups), "
              f"bit-stable, containers == host coder's, escapes "
              f"{ne.tolist()}")
    y = recorded[0]
    flip = y[0].clone()
    # a symbol inside its row, moved to its neighbour
    flip[0, 1000] += 1 if int(flip[0, 1000]) <= 0 else -1
    check(not torch.equal(lane_encode_rounds(flip, *y[1:])[0],
                          lane_encode_rounds(*y)[0]),
          "E1: a flipped symbol left the words unchanged")
    e = esc_calls[0]
    e_lane = e1_lane_order(e)
    _, _, efp, efv, ene = lane_encode_rounds(*e)
    host = lane_encode(e_lane[0][0].cpu().numpy(),
                       e_lane[1][0].cpu().numpy(), st.off, e[2].shape[1],
                       *[a.cpu().numpy() for a in e[3:6]], fix_cap=1 << 16)
    f = int(ene[0])
    check(e[6] is None and f == host[2].size > cap and
          np.array_equal(efp[0, :f].cpu().numpy(), host[2]) and
          np.array_equal(efv[0, :f].cpu().numpy(), host[3]),
          f"E1 escapes: n_esc {f} vs the host's {host[2].size}, codec cap "
          f"{cap}, E1's {e[6]}")
    _, _, cfp, cfv, cne = lane_encode_rounds(*e[:6], cap, *e[7:])
    check(int(cne[0]) == f and
          np.array_equal(cfp[0].cpu().numpy(), host[2][:cap]) and
          np.array_equal(cfv[0].cpu().numpy(), host[3][:cap]),
          f"E1 at fix_cap {cap}: n_esc {int(cne[0])} (expected {f}) or the "
          "stored fixups != the host coder's first")
    print(f"E1 escapes: {f} in image 0, more than the codec's cap of {cap}: "
          f"all stored, equal to the host coder's; at fix_cap {cap} (JAX's "
          f"contract) counted, the first {cap} stored")

    build = {n: r for n, r in ptxas.items() if "lane_encode_kernel" in n}
    check(len(build) == 1 and all(r["registers"] for r in build.values()),
          f"E1's ptxas report: {ptxas}")
    regs = next(iter(build.values()))["registers"]
    spills = next(iter(build.values()))["spill_bytes"]
    op_y, op_z = e1_op_args(y), e1_op_args(recorded[1])
    walk_y = launch_walk(*op_y)
    ms = graph_time_ms(lambda: launch_walk(*op_y))
    eager_ms = cuda_time_ms(lambda: launch_walk(*op_y), 20)
    call_ms = graph_time_ms(lambda: lane_encode_rounds(*y))
    call_eager_ms = cuda_time_ms(lambda: lane_encode_rounds(*y), 20)
    lane_y = e1_lane_order(y)
    fixups_ms = graph_time_ms(lambda: device_rans.lane_fixups(
        lane_y[0], walk_y[2], None))
    z_ms = graph_time_ms(lambda: launch_walk(*op_z))
    z_call_ms = graph_time_ms(lambda: lane_encode_rounds(*recorded[1]))
    plain_ms = cuda_time_ms(lambda: device_rans.lane_encode_walk(*op_y), 1,
                            1)
    clock = max_sm_clock_ghz()
    load_clock = sm_clock_under_load_ghz(lambda: launch_walk(*op_y))
    cyc_clock = load_clock or clock
    bound = e1_bound(op_y, y_esc, clock)
    n, k = walk_y[1].shape
    t_steps = y[2].shape[0]
    cycles = ms * 1e-3 * cyc_clock * 1e9 / t_steps
    chain = t_steps * STEP_CHAIN_INSTR * INT_LATENCY_CYCLES / clock * 1e-6
    print(f"E1 build: {regs} registers, {spills} B spilled [{card}]")
    print(f"E1 y (N{n} K{k} T{t_steps}): kernel {ms:.4f} ms as a CUDA-graph "
          f"replay (eager {eager_ms:.4f}); the whole wrapper (the op, then "
          f"the fixups) {call_ms:.4f} ms (eager {call_eager_ms:.4f}), the "
          f"fixups alone {fixups_ms:.4f} ms; z kernel {z_ms:.4f} ms, wrapper "
          f"{z_call_ms:.4f} ms; plain twin {plain_ms:.4f} ms; host coder on "
          f"the same symbols, {n} images one after another: y "
          f"{host_ms[0]:.3f} ms, z {host_ms[1]:.3f} ms [{card}]")
    print(f"E1 cycles a step (time x the SM clock, "
          f"{'sampled under load' if load_clock else 'max'} "
          f"{cyc_clock:.3f} GHz, / T): v2 {cycles:.1f}, before (v1, as "
          f"PERF.md records it, PR 18 run D; not measured here) "
          f"{E1_V1_CYCLES}; bound "
          f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']}: "
          f"{bound['bytes'] / 1e6:.3f} MB, {bound['ops'] / 1e6:.2f} M int "
          f"ops) beside a chain estimate, not measured, at an ASSUMED "
          f"{STEP_CHAIN_INSTR} dependent instructions a step of "
          f"{INT_LATENCY_CYCLES} cycles at the max SM clock: {chain:.4f} ms "
          f"[{card}]")
    return dict(ms=ms, eager_ms=eager_ms, call_ms=call_ms,
                call_eager_ms=call_eager_ms, fixups_ms=fixups_ms, z_ms=z_ms,
                z_call_ms=z_call_ms, plain_ms=plain_ms, host_ms=host_ms[0],
                host_z_ms=host_ms[1], cycles_per_step=cycles,
                cycles_clock_mhz=cyc_clock * 1e3, registers=regs,
                spill_bytes=spills, max_abs_err=err,
                shape=f"N{n} K{k} T{t_steps}, y table "
                      f"{tuple(y[3].shape)}", **bound)


def cb_model(card: str, fused: bool = True):
    """config/cb_stage2.yaml with crdr_throughput.yaml's codec options laid
    over it (``fused_slice_kernel`` = ``fused``), seeded init (the spatial
    convs too), y scales raised."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import Config

    cfg = Config.from_file(os.path.join(ROOT, "config", "cb_stage2.yaml"))
    served = Config.from_file(os.path.join(ROOT, "config",
                                           "crdr_throughput.yaml"))
    for key in THROUGHPUT_OPTIONS:
        cfg[key] = served[key]
    cfg["fused_slice_kernel"] = fused
    t0 = time.perf_counter()
    model = build_comp_model(cfg)
    raise_y_scales(model)
    model.codec_setup()
    torch.cuda.synchronize()
    spat = float(model._packed["spat_w"].abs().max())
    check(model._is_checkerboard and spat > 0,
          f"checkerboard model: spatial convs {spat}")
    nparam = sum(p.numel() for p in model.net.parameters())
    print(f"checkerboard (cb_stage2.yaml, {cfg.model_type}): "
          f"{nparam / 1e6:.1f}M params, spatial convs "
          f"{tuple(model._packed['spat_w'].shape)} max |w| {spat:.4f}, "
          f"fused_slice_kernel={model.fused_slice_kernel}, built in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return model


def checkerboard_phase(imgs, card: str, profiling: bool = False):
    """Phase 13: the checkerboard on the compressai wire (the checks of
    phase 3, K1 60), on the device wire with each encoder (the checks of
    phase 4, K2 21; y_hat equal to the compressai wire's, streams equal
    across encoders, batch 1 == batch 4), then K1 off on the compressai wire
    (the plain chain, K1 0).  Returns ({path: launches}, {path: times})."""
    import torch

    counts, times = {}, {}
    model = cb_model(card)
    k1 = 6 * model.num_slices
    encs, counts["checkerboard"], times["checkerboard"] = host_wire_path(
        model, imgs, "checkerboard",
        {"slice_transform": k1, "lane_decode_round": 0, "gdn": 0}, card,
        runs=SIDE_RUNS, padding=False)
    y_c = np.concatenate([e["y_hat"] for e in encs])
    streams = {}
    for enc in ("host", "device"):
        label = f"checkerboard device wire, {enc} encoder"
        _, counts[label], times[label], e = device_wire_path(
            model, imgs, y_c, card, label, encoder=enc, runs=SIDE_RUNS)
        streams[enc] = [x["string_list"] for x in e]
    check(streams["host"] == streams["device"],
          "checkerboard: the device encoder's streams != the host encoder's")
    print("checkerboard device wire: streams equal across the two encoders")
    if profiling:
        profile_phase(lambda: model.decompress_batch(
            streams["device"], beta=BETA),
            f"checkerboard device-wire decode batch {N_IMG}", card,
            ("k1_", "lane_decode_round_kernel"))
    del model, encs
    torch.cuda.empty_cache()
    model = cb_model(card, fused=False)
    label = "checkerboard K1 off"
    _, counts[label], times[label] = host_wire_path(
        model, imgs, label,
        {"slice_transform": 0, "lane_decode_round": 0, "gdn": 0}, card,
        runs=SIDE_RUNS, padding=False)
    del model
    torch.cuda.empty_cache()
    return counts, times


def k2_long_round(recorded, label: str, card: str) -> dict:
    """K2 against its twin on the generic device wire's y round (m =
    491,520, T = 3,840 a lane at K 128), and its time."""
    import torch

    from crdr_tpu_torch.ops.device_rans import lane_decode_round_instep
    from crdr_tpu_torch.ops.lane_decode import lane_decode_round

    y = recorded[1]
    got = lane_decode_round(*y)
    ref = lane_decode_round_instep(*y[:4], y[4].cdf, y[4].cdf_len,
                                   y[4].cdf_off, y[5])
    torch.cuda.synchronize()
    for a, b, name in zip(got, ref, ("values", "states", "pointers")):
        check(torch.equal(a, b), f"{label}: K2 != twin on the long y round "
                                 f"in {name}")
    ms = graph_time_ms(lambda: lane_decode_round(*y), iters=5)
    n, k = y[0].shape
    print(f"{label}: K2 == twin on the y round N{n} K{k} m {y[5]} "
          f"(T {-(-y[5] // k)}); {ms:.4f} ms as a CUDA-graph replay [{card}]")
    return {"m": y[5], "ms": ms}


def generic_device_phase(imgs, card: str):
    """Phase 14: the generic device wire on beta_cond_interp_ca_elic_
    hyperprior and on the GDN path (balle18_mean_scale.yaml, K3 6 a round
    trip): the compressai wire for the reference y_hat, then the device wire
    with each encoder (K2 2 a decode, E1 2 an encode with the device
    encoder; y_hat equal to the compressai wire's, streams equal across
    encoders, real vs predicted bpp), and K2 against its twin on the long y
    round.  Returns ({path: launches}, {path: times}, long-round figures)."""
    import torch

    counts, times, long = {}, {}, {}
    for name in ("beta_cond_interp_ca_elic_hyperprior", "GDN path"):
        gdn = 6 if name == "GDN path" else 0
        model = build_gdn_model(imgs, card) if gdn else class_model(name,
                                                                    card)
        label = f"{name} compressai"
        encs, counts[label], times[label] = host_wire_path(
            model, imgs, label,
            {"slice_transform": 0, "lane_decode_round": 0, "gdn": gdn}, card,
            runs=SIDE_RUNS, padding=False)
        y_c = np.concatenate([e["y_hat"] for e in encs])
        streams = {}
        for enc in ("host", "device"):
            label = f"{name} device wire, {enc} encoder"
            recorded, counts[label], times[label], e = device_wire_path(
                model, imgs, y_c, card, label, encoder=enc, gdn=gdn,
                runs=SIDE_RUNS)
            streams[enc] = [x["string_list"] for x in e]
        check(streams["host"] == streams["device"],
              f"{name}: the device encoder's streams != the host encoder's")
        print(f"{name} device wire: streams equal across the two encoders")
        long[name] = k2_long_round(recorded, name, card)
        del model, encs
        torch.cuda.empty_cache()
    return counts, times, long


# ---------------- phase 15: training (stages 1 and 2) ------------------------

TRAIN_STEPS = 20      # stage 1 through build_trainer(...).train_loop()
FALL_STEPS = 15       # on one fixed batch: the last 5 below the first 5
SHORT_STEPS = 12      # stage 2, the checkerboard, the GDN model
WARM_STEPS = 5        # steps left out of the step-time statistics
RESUME_K = 3          # resume: save at step k, rebuild, run to 2k
CMP_BATCH = 2         # the card-vs-CPU f32 step (the CPU runs it too)
CLI_STEPS = 3         # each train CLI run's steps
TRAIN_RTOL, GRAD_REL = 1e-4, 1e-3
# NVIDIA's data sheet, H100 SXM, dense, at 700 W: bf16 / TF32 / f32 TFLOP/s
PEAK_TFLOPS = {"bf16": 989.0, "tf32": 495.0, "f32": 67.0}


def train_config(name: str, tmp: str, exp: str, **over):
    """A training config of config/ with its checkpoints under ``tmp``,
    seed 0, no validation or rolling save in the run, and ``over`` laid on
    top."""
    from crdr_tpu_torch.utils.config import Config, fill_paths

    cfg = Config.from_file(os.path.join(ROOT, "config", name))
    cfg.update({"ckpt_root": tmp, "exp": exp, "seed": 0,
                "eval_step": 10 ** 9, "save_step": 10 ** 9,
                "time_step": 10 ** 9, "log_step": 10,
                "total_iter": TRAIN_STEPS, **over})
    fill_paths(cfg)
    return cfg


def record_steps(tr):
    """Wraps the trainer's step: each step timed between two synchronizes,
    its device log and its sampled rate_ind kept.  Returns the three lists."""
    import torch

    logs, times, rates = [], [], []
    step, controls = tr.optimize_parameters_device, tr.sample_controls

    def timed(itr, data):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log = step(itr, data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        logs.append(log)
        return log

    def sampled(itr):
        out = controls(itr)
        rates.append(out[0])
        return out

    tr.optimize_parameters_device, tr.sample_controls = timed, sampled
    return logs, times, rates


def check_logs(logs, label: str) -> dict:
    """Every loss of every step finite, no step skipped; the last step's
    losses."""
    import torch

    keys = sorted(logs[0])
    vals = torch.stack([torch.stack([log[k].float().reshape(())
                                     for k in keys]) for log in logs]).cpu()
    check(bool(torch.isfinite(vals).all()), f"{label}: a non-finite loss")
    check(not vals[:, keys.index("skipped")].any(), f"{label}: a step was "
          "skipped")
    return dict(zip(keys, vals[-1].tolist()))


def step_flops(tr, data) -> float:
    """Model FLOPs of one training step: 3 x the convolutions' (and GDN's)
    forward FLOPs in the net (forward, and the input and weight gradients)
    + 1.5 x LPIPS's (both images forward, the fake one's input gradient;
    its weights are frozen), counted by forward hooks over one step."""
    from crdr_tpu_torch.nn import GDN, Conv2d, ConvTranspose2d

    total = {"net": 0, "lpips": 0}
    handles = []

    def hook(part):
        def count(m, inp, out):
            if isinstance(m, GDN):  # gamma . x^2 over C x C a pixel
                total[part] += 2 * inp[0].numel() * m.gamma.shape[0]
            elif isinstance(m, ConvTranspose2d):
                total[part] += 2 * inp[0].numel() * m.weight[0].numel()
            else:
                total[part] += 2 * out.numel() * m.weight[0].numel()
        return count

    roots = [("net", tr.comp_model.net)]
    if tr.perceptual_loss is not None:
        roots.append(("lpips", tr.perceptual_loss))
    for part, root in roots:
        handles += [m.register_forward_hook(hook(part)) for m in
                    root.modules()
                    if isinstance(m, (Conv2d, ConvTranspose2d, GDN))]
    try:
        tr.optimize_parameters_device(tr.step + 1, data)
    finally:
        for h in handles:
            h.remove()
    return 3.0 * total["net"] + 1.5 * total["lpips"]


def train_stats(label, cfg, times, flops, peak, card: str) -> dict:
    """Median step time after WARM_STEPS (and its quartiles and range),
    images/s, peak memory, model FLOPs a step and their share of each
    peak."""
    timed = times[WARM_STEPS:]
    ms = float(np.median(timed))
    q1, q3 = (float(v) for v in np.percentile(timed, [25, 75]))
    batch = cfg.dataset.batch_size
    size = cfg.dataset.train_dataset.image_size
    res = {"ms_per_step": ms, "images_per_s": batch / ms * 1e3,
           "peak_mem_gib": peak / 2 ** 30, "gflop_per_step": flops / 1e9,
           "steps_timed": len(timed), "q1_ms": q1, "q3_ms": q3,
           "min_ms": float(min(timed)), "max_ms": float(max(timed)),
           "mixed_precision": bool(cfg.get("mixed_precision", False))}
    for kind, peak_tf in PEAK_TFLOPS.items():
        res[f"share_{kind}"] = flops / (ms * 1e-3) / (peak_tf * 1e12)
    print(f"train {label}: batch {batch} x {size}x{size}, median "
          f"{ms:.1f} ms a step over {res['steps_timed']} steps (each between "
          f"two synchronizes; quartiles {q1:.1f}-{q3:.1f}, range "
          f"{res['min_ms']:.1f}-{res['max_ms']:.1f}; runs "
          f"{[round(t, 1) for t in times]}), "
          f"{res['images_per_s']:.1f} images/s, peak memory "
          f"{res['peak_mem_gib']:.2f} GiB, {flops / 1e12:.3f} TFLOP a step: "
          + ", ".join(f"{res[f'share_{k}']:.4f} of the {k} peak"
                      for k in PEAK_TFLOPS) + f" [{card}]")
    return res


def train_run(label, cfg, card: str, kernels: dict):
    """build_trainer + train_loop on the card, every count set to 0 just
    before train_loop and read after.  Returns (trainer, stats, logs,
    rates, {kernel: launches}, the seeded init's state_dict on the CPU)."""
    import torch

    from crdr_tpu_torch.trainer import build_trainer

    t0 = time.perf_counter()
    tr = build_trainer(cfg)  # the GPU
    print(f"train {label}: {cfg.model_type} built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in tr.comp_model.net.parameters()) / 1e6:.1f}"
          f"M params")
    check(tr.comp_model.device.type == "cuda", f"{label}: not on the card")
    init = {k: v.detach().cpu().clone()
            for k, v in tr.comp_model.state_dict().items()}
    logs, times, rates = record_steps(tr)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    tr.train_loop()
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    last = check_logs(logs, label)
    print(f"train {label}: {len(logs)} steps, all losses finite, none "
          f"skipped; last step " + ", ".join(
              f"{k} {v:.4f}" for k, v in last.items()) + f"; launches {counts}")
    stats = train_stats(label, cfg, list(times), step_flops(
        tr, next(iter(tr.train_loader))), peak, card)
    return tr, stats, logs, rates, counts, init


def gate_replay(ref=None):
    """A TorchFunctionMode over one training forward that records, in call
    order, each ReLU's and leaky ReLU's gate (input > 0), each max pool's
    picks and each lower bound's gate (input >= bound).  Given ``ref``,
    another forward's record, the (leaky) ReLUs and max pools follow
    ``ref``'s gates and picks instead of their own, so two devices compute
    the same piece of the piecewise function (the lower bounds are recorded
    only)."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    relus = (torch.relu, F.relu, torch.Tensor.relu)
    leaky = (F.leaky_relu,)

    class GateReplay(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.rec = {"relu": [], "max_pool": [], "lower_bound": []}

        def _ref(self, kind, like):
            got = ref[kind][len(self.rec[kind]) - 1]
            check(got.shape == like.shape, f"gate replay: {kind} call "
                  f"{len(self.rec[kind])} has shape {tuple(like.shape)}, "
                  f"the reference's {tuple(got.shape)}")
            return got.to(like.device)

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in relus:
                x = args[0]
                self.rec["relu"].append((x > 0).detach())
                if ref is None:
                    return func(*args, **kwargs)
                return torch.where(self._ref("relu", x), x,
                                   torch.zeros_like(x))
            if func in leaky:  # x > 0 passes, else slope * x
                x = args[0]
                slope = args[1] if len(args) > 1 else kwargs.get(
                    "negative_slope", 0.01)
                self.rec["relu"].append((x > 0).detach())
                if ref is None:
                    return func(*args, **kwargs)
                return torch.where(self._ref("relu", x), x, x * slope)
            if func is F.max_pool2d:
                kw = {k: v for k, v in kwargs.items() if k != "return_indices"}
                out, idx = F.max_pool2d_with_indices(*args, **kw)
                self.rec["max_pool"].append(idx)
                if ref is None:
                    return out
                x = args[0]
                pick = self._ref("max_pool", idx)
                return x.flatten(2).gather(2, pick.flatten(2)).view_as(out)
            if func is torch.clamp and "min" in kwargs and \
                    isinstance(kwargs["min"], float):
                self.rec["lower_bound"].append(
                    (args[0] >= kwargs["min"]).detach())
            return func(*args, **kwargs)

    return GateReplay()


def gates_apart(a: dict, b: dict) -> dict:
    """Elements whose gate (or max pool pick) differs between two records of
    the same forward, by kind: their count and, for each call with any,
    [call index, shape, count]."""
    out = {}
    for kind, xs in a.items():
        check(len(xs) == len(b[kind]), f"gate records: {len(xs)} {kind} "
              f"calls against {len(b[kind])}")
        calls = [[i, list(x.shape), int((x.cpu() != y.cpu()).sum())]
                 for i, (x, y) in enumerate(zip(xs, b[kind]))]
        calls = [c for c in calls if c[2]]
        out[kind] = {"elements": sum(c[2] for c in calls), "calls": calls}
    return out


def train_grads(trainer, batch, noise, dtype=None, gates=None):
    """One training forward and backward in ``dtype`` (f32 by default; the
    trainer's net and perceptual loss already in it), no optimizer step:
    the losses, the parameters' gradients (float64, on the CPU), the
    quantized latents {"y", "z"} (on the CPU) and, with ``gates`` (a
    gate_replay mode), that mode's record."""
    import contextlib

    import torch

    trainer.comp_model.net.zero_grad(set_to_none=True)
    x = trainer.put_batch(batch)
    with gates if gates is not None else contextlib.nullcontext():
        losses, out, _ = trainer._g_losses(x.to(dtype or x.dtype), 0.0, 0.0,
                                           noise)
    total = sum(losses.values())
    total.backward()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in trainer.comp_model.net.named_parameters()
             if p.grad is not None}
    trainer.comp_model.net.zero_grad(set_to_none=True)
    return {**{k: float(v.detach()) for k, v in losses.items()},
            "total": float(total.detach())}, grads, {
        k: v.detach().cpu() for k, v in out["quantized_code"].items()}, \
        gates.rec if gates is not None else None


def compare_steps(a, b):
    """(max relative loss difference, [(relative L2 error, name)] worst
    first) of two train_grads results; ``b`` is the reference."""
    import torch

    (la, ga), (lb, gb) = a[:2], b[:2]
    check(set(ga) == set(gb), "the two steps' gradients have other names")
    loss_rel = max(abs(la[k] - v) / max(abs(v), 1e-30) for k, v in lb.items())
    errs = []
    for name, ref in gb.items():
        norm = float(torch.linalg.vector_norm(ref))
        err = float(torch.linalg.vector_norm(ga[name] - ref))
        errs.append((err / norm if norm > 0 else err, name))
    return loss_rel, sorted(errs, reverse=True)


def step_row(mine, ref) -> dict:
    """One comparison of two train_grads results (``ref`` the reference):
    the largest loss and gradient differences, the gradients over GRAD_REL
    and the quantized values the two rounded to other integers (the STE's
    round near a half-integer: a step of the forward)."""
    loss_rel, errs = compare_steps(mine, ref)
    return {"max_loss_rel": loss_rel, "max_grad_rel_l2": errs[0][0],
            "worst": errs[0][1], "next": errs[1:4], "gradients": len(errs),
            "over_limit": [n for e, n in errs if e > GRAD_REL],
            "rounded_apart": {k: int(((mine[2][k] - v).abs() > 0.5).sum())
                              for k, v in ref[2].items()}}


def say_row(what: str, row: dict) -> str:
    return (f"{what}: max relative loss difference "
            f"{row['max_loss_rel']:.3e}; {row['gradients']} gradients, max "
            f"relative L2 error {row['max_grad_rel_l2']:.3e} ({row['worst']}), "
            f"{len(row['over_limit'])} over {GRAD_REL} {row['over_limit']}; "
            f"next: " + ", ".join(f"{n} {e:.2e}" for e, n in row["next"])
            + f"; quantized values rounded apart {row['rounded_apart']}")


def card_vs_cpu_phase(tr, init_state, tmp: str, batch, card: str) -> dict:
    """The same weights, batch and noise through one f32 training step
    (TF32 off) on the card and on the CPU.

    At the seeded init: every loss within TRAIN_RTOL and every gradient
    within a relative L2 error of GRAD_REL of the CPU's.  At stage 1's
    trained weights the reference is a float64 CPU step.  Each ReLU gate,
    max pool pick and lower-bound gate that an f32 step sets otherwise
    than the float64 one is counted; then the card and the f32 CPU run
    again with their ReLUs and max pools held to the float64 step's gates
    and picks, and each of the two must be within TRAIN_RTOL and GRAD_REL
    of the float64 step and of each other.  Among the free steps (card, f32
    CPU, float64 CPU), every pair's losses are within TRAIN_RTOL, and a
    gradient over GRAD_REL passes only where the two steps set some gate
    apart (the calls that did are printed).  The card's own f32 spread
    (the same step with other cuDNN algorithms: deterministic off,
    autotuning on) is printed beside it."""
    import torch

    from crdr_tpu_torch.trainer import build_trainer

    def cpu_trainer(exp):
        return build_trainer(train_config("endurance_stage1.yaml", tmp, exp,
                                          mixed_precision=False),
                             device="cpu")

    cpu = cpu_trainer("f32cpu")
    trained = {k: v.detach().cpu().clone()
               for k, v in tr.comp_model.state_dict().items()}
    drawn, g = {}, torch.Generator().manual_seed(1)

    def record(name, like):
        drawn[name] = torch.rand(like.shape, generator=g,
                                 dtype=torch.float32) - 0.5
        return drawn[name].to(like.dtype)

    def replay(name, like):
        return drawn[name].to(like.device, like.dtype)

    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             tr.opt.get("mixed_precision"))
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    tr.opt["mixed_precision"] = False
    res = {}
    try:
        # the seeded init: the card against the f32 CPU
        for t in (cpu, tr):
            t.comp_model.load_state_dict(init_state, strict=True)
        t0 = time.perf_counter()
        ref = train_grads(cpu, batch, record)
        cpu_s = time.perf_counter() - t0
        res["init"] = row = step_row(train_grads(tr, batch, replay), ref)
        print(say_row(f"card vs CPU, f32 (TF32 off), batch {CMP_BATCH}, "
                      "init weights", row) + f"; the CPU step took "
              f"{cpu_s:.1f} s [{card}]")

        # stage 1's trained weights: both against a float64 CPU step
        f64 = cpu_trainer("f64cpu")
        f64.comp_model.load_state_dict(trained, strict=True)
        f64.comp_model.net.double()
        f64.perceptual_loss.double()
        for t in (cpu, tr):
            t.comp_model.load_state_dict(trained, strict=True)
        t0 = time.perf_counter()
        ref = train_grads(f64, batch, replay, torch.float64, gate_replay())
        f64_s = time.perf_counter() - t0
        del f64
        free = {"card": train_grads(tr, batch, replay, gates=gate_replay()),
                "cpu": train_grads(cpu, batch, replay, gates=gate_replay())}
        held = {k: train_grads(t, batch, replay,
                               gates=gate_replay(ref[3]))
                for k, t in (("card", tr), ("cpu", cpu))}
        b.cudnn.deterministic, b.cudnn.benchmark = False, True
        try:
            train_grads(tr, batch, replay)  # autotune
            spread = step_row(train_grads(tr, batch, replay), free["card"])
        finally:
            b.cudnn.deterministic, b.cudnn.benchmark = True, False
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
         tr.opt["mixed_precision"]) = saved
    rows = {
        "card vs CPU f32, free": step_row(free["card"], free["cpu"]),
        "card vs f64, free": step_row(free["card"], ref),
        "CPU f32 vs f64, free": step_row(free["cpu"], ref),
        "card vs f64, gates held": step_row(held["card"], ref),
        "CPU f32 vs f64, gates held": step_row(held["cpu"], ref),
        "card vs CPU f32, gates held": step_row(held["card"], held["cpu"])}
    apart = {"card vs CPU f32": gates_apart(free["card"][3], free["cpu"][3]),
             "card vs f64": gates_apart(free["card"][3], ref[3]),
             "CPU f32 vs f64": gates_apart(free["cpu"][3], ref[3])}
    calls = {k: len(v) for k, v in ref[3].items()}
    print(f"card vs CPU, trained weights, batch {CMP_BATCH}: float64 CPU "
          f"reference step {f64_s:.1f} s; gate calls {calls}; gates set "
          f"apart (elements; [call, shape, elements]) {apart}; the card's "
          f"own spread (other cuDNN algorithms): max {spread['max_grad_rel_l2']:.3e} ({spread['worst']})")
    for what, row in rows.items():
        print(say_row(f"  {what}", row) + f" [{card}]")
    res["trained"] = {**{k: {x: r[x] for x in ("max_loss_rel",
                                                "max_grad_rel_l2", "worst",
                                                "over_limit")}
                         for k, r in rows.items()},
                      "gates_apart": apart, "gate_calls": calls,
                      "card_spread_max": spread["max_grad_rel_l2"]}

    def holds(row, what):
        check(row["max_loss_rel"] <= TRAIN_RTOL, f"{what}: losses differ by "
              f"{row['max_loss_rel']:.3e} (rtol {TRAIN_RTOL})")
        check(row["max_grad_rel_l2"] <= GRAD_REL, f"{what}: gradient "
              f"{row['worst']} off by {row['max_grad_rel_l2']:.3e} (relative "
              f"L2, limit {GRAD_REL})")

    holds(res["init"], "card vs CPU, f32, init weights")
    for what in ("card vs f64, gates held", "CPU f32 vs f64, gates held",
                 "card vs CPU f32, gates held"):
        holds(rows[what], f"trained weights, {what}")
    for what, pair in (("card vs CPU f32, free", "card vs CPU f32"),
                       ("card vs f64, free", "card vs f64"),
                       ("CPU f32 vs f64, free", "CPU f32 vs f64")):
        check(rows[what]["max_loss_rel"] <= TRAIN_RTOL, f"trained weights, "
              f"{what}: losses differ by {rows[what]['max_loss_rel']:.3e}")
        check(not rows[what]["over_limit"] or any(
            v["elements"] for v in apart[pair].values()),
            f"trained weights, {what}: gradients {rows[what]['over_limit']} "
            "differ past the limit with every gate set alike")
    del cpu
    return res


def train_split(tr, data, card: str, steps: int = 5) -> dict:
    """The stage-1 step's forward (batch upload and losses), backward and
    optimizer (main and aux) ms, each between two synchronizes: medians of
    ``steps`` steps, the trainer's step taken apart (--profile)."""
    import torch

    parts = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = tr.put_batch(data["real_images"])
        rate_ind, beta, mults = tr.sample_controls(tr.step + 1)
        losses, _, _ = tr._g_losses(batch, rate_ind, beta, tr.noise, mults)
        total = sum(losses.values())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.g_opt.zero_grad()
        total.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        skip = tr.loss_anomaly_flag(total.detach())
        tr.g_opt.step(skip)
        aux = tr.comp_model.net.aux_loss()
        tr.aux_opt.zero_grad()
        aux.backward()
        tr.aux_opt.step(skip)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        tr.step += 1
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
    res = {k: float(np.median(v)) for k, v in parts.items()}
    print("train stage 1 step, taken apart, medians of "
          f"{steps}: " + ", ".join(f"{k} {v:.1f} ms" for k, v in res.items())
          + f" [{card}]")
    return res


def resume_check(tmp: str, card: str) -> dict:
    """Save at step k, rebuild the trainer from the checkpoint, run to 2k
    on the same batches: the parameters and both optimizers' states must be
    bit-equal to the uninterrupted run's (cuDNN deterministic, no
    autotuning, as the trainer sets)."""
    import torch

    from crdr_tpu_torch.data import cycle
    from crdr_tpu_torch.trainer import build_trainer

    k = RESUME_K
    a = build_trainer(train_config("endurance_stage1.yaml", tmp, "resume"))
    check(torch.backends.cudnn.deterministic and
          not torch.backends.cudnn.benchmark, "resume: cuDNN must be "
          "deterministic, without autotuning")
    data = [d for _, d in cycle(a.train_loader, 0, 2 * k)]
    for i in range(k):
        a.optimize_parameters_device(i + 1, data[i])
    a.save(k)
    for i in range(k, 2 * k):
        a.optimize_parameters_device(i + 1, data[i])
    b = build_trainer(train_config("endurance_stage1.yaml", tmp, "resume",
                                   start_iter=k))
    for i in range(k, 2 * k):
        b.optimize_parameters_device(i + 1, data[i])
    torch.cuda.synchronize()
    pairs = [(f"param {n}", p.detach(), q.detach()) for (n, p), (_, q) in
             zip(a.comp_model.net.named_parameters(),
                 b.comp_model.net.named_parameters())]
    for label, oa, ob in (("g", a.g_opt, b.g_opt), ("aux", a.aux_opt,
                                                     b.aux_opt)):
        pairs += [(f"{label} {key}", oa.state[key], ob.state[key])
                  for key in oa.state]
    diff = {name: float((x.double() - y.double()).abs().max())
            for name, x, y in pairs if not torch.equal(x, y)}
    worst = max(diff.items(), key=lambda kv: kv[1]) if diff else (None, 0.0)
    print(f"resume: saved at step {k}, rebuilt from the checkpoint, run to "
          f"{2 * k}: {len(pairs) - len(diff)} of {len(pairs)} tensors "
          f"bit-equal to the uninterrupted run's; largest difference "
          f"{worst[1]:.3e} ({worst[0]}) [{card}]")
    check(not diff, f"resume is not bit-equal: {len(diff)} tensors differ, "
          f"the largest by {worst[1]:.3e} ({worst[0]})")
    del a, b
    return {"tensors": len(pairs), "differing": len(diff)}


def train_cli_start(tmp: str, ckpt1: str) -> dict:
    """Starts python -m crdr_tpu_torch.cli.train on config/endurance_stage1
    .yaml and on config/endurance_stage3.yaml (the card by default), 3 steps
    each, in directories of their own under ``tmp``, both in the background
    beside phase 15's card-vs-CPU step; stage 3 finds phase 15's stage-1
    checkpoint ``ckpt1`` at the recipe's warm-start path.
    ``cli_train_check`` and ``gan_cli_check`` check them."""
    from crdr_tpu_torch.utils.config import Config

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = {}
    for stage in (1, 3):
        recipe = os.path.join(ROOT, "config", f"endurance_stage{stage}.yaml")
        cwd = os.path.join(tmp, f"cli{stage}")
        os.makedirs(cwd)
        if stage == 3:
            warm = os.path.join(cwd, Config.from_file(
                recipe).pretrained_weight_path)
            os.makedirs(os.path.dirname(warm), exist_ok=True)
            shutil.copyfile(ckpt1, warm)
        cmd = [sys.executable, "-m", "crdr_tpu_torch.cli.train", recipe,
               "-ti", str(CLI_STEPS), "-s", str(CLI_STEPS), "-l", "1",
               "-e", "1000000"]
        procs[stage] = start_proc(cmd, cwd, cwd + ".log", env)
        procs[stage]["cwd"] = cwd
    return procs


def cli_train_check(p: dict, card: str) -> float:
    """The stage-1 run of ``train_cli_start``: it writes its checkpoints, its
    loss CSV and its config dump."""
    steps, cmd = CLI_STEPS, p["cmd"]
    rc, log, dt = end_proc(p)
    check(rc == 0, f"the train CLI exited {rc}:\n{log[-6000:]}")
    job = os.path.join(p["cwd"], "checkpoint", "endurance_stage1")
    for name in (f"comp_model_iter{steps}.ckpt",
                 f"training_state_iter{steps}.ckpt"):
        check(os.path.exists(os.path.join(job, "model", name)),
              f"the train CLI wrote no {name}")
    with open(os.path.join(job, "log_loss.csv")) as f:
        rows = f.read().strip().splitlines()
    check(len(rows) == steps + 1, f"the train CLI's log_loss.csv: {rows}")
    check(os.path.exists(os.path.join(job, "endurance_stage1_dump.yaml")),
          "the train CLI wrote no config dump")
    print(f"train CLI: {' '.join(cmd[1:3])} endurance_stage1.yaml -ti "
          f"{steps}: {dt:.1f} s (process start and model build included; "
          f"beside the card-vs-CPU step and the stage-3 CLI), checkpoints, "
          f"{steps} loss rows and the config dump written [{card}]")
    return dt


def k3_training_ms(card: str) -> dict:
    """K3's six calls of a GDN training step (batch 8, 256x256: GDN at
    128x128, 64x64, 32x32 and IGDN back up, 192 channels), each a CUDA-graph
    replay, no gradient."""
    import torch

    from crdr_tpu_torch.ops.gdn import gdn

    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for side in (128, 64, 32):
        x = torch.randn((8, 192, side, side), device="cuda", generator=g)
        beta = torch.rand(192, device="cuda", generator=g) + 0.5
        gamma = torch.rand((192, 192), device="cuda", generator=g) * 0.1
        for inverse in (False, True):
            out[f"{side}x{side} {'igdn' if inverse else 'gdn'}"] = \
                graph_time_ms(lambda: gdn(x, beta, gamma, inverse))
    total = sum(out.values())
    print(f"K3 in a GDN training step: {total:.4f} ms for its six calls "
          f"({', '.join(f'{k} {v:.4f}' for k, v in out.items())}) [{card}]")
    return {"ms_per_step": total, "ms_by_call": out}


def training_phase(card: str, profiling: bool = False) -> dict:
    """Phase 15: rate-distortion training on the card at full width; with
    ``profiling``, stage 1's step taken apart and profiled."""
    import tempfile

    import torch

    from crdr_tpu_torch.nn import GDN
    from crdr_tpu_torch.utils.config import Config

    kernels = kernel_wrappers()
    res, counts = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # 1. stage 1: endurance_stage1.yaml
        cfg1 = train_config("endurance_stage1.yaml", tmp, "stage1")
        tr, res["stage1"], _, _, counts["train stage1"], init1 = train_run(
            "stage 1 (endurance_stage1.yaml)", cfg1, card, kernels)
        fixed = next(iter(tr.train_loader))
        if profiling:
            res["stage1"]["split_ms"] = train_split(tr, fixed, card)
            profile_phase(lambda: [tr.optimize_parameters_device(
                tr.step + 1, fixed) for _ in range(3)],
                "stage 1 training, 3 steps", card)
        totals = [tr.optimize_parameters_device(tr.step + 1, fixed)["total"]
                  for _ in range(FALL_STEPS)]
        totals = torch.stack(totals).cpu().tolist()
        first, last = np.mean(totals[:5]), np.mean(totals[-5:])
        print(f"train stage 1, one fixed batch, {FALL_STEPS} steps: mean "
              f"total loss of the first 5 {first:.4f}, of the last 5 "
              f"{last:.4f} ({[round(t, 4) for t in totals]})")
        check(np.isfinite(totals).all() and last < first,
              "stage 1: the loss did not fall on a fixed batch")
        res["stage1"]["loss_first5"], res["stage1"]["loss_last5"] = \
            first, last
        tr.save(tr.step)
        ckpt1 = tr.path_handler.get_ckpt_path("comp_model", tr.step)
        n_stage1 = len(tr.comp_model.state_dict())
        clis = train_cli_start(tmp, ckpt1)  # checked at 7 and in phase 16

        # 2. the card against the CPU, f32
        res["card_vs_cpu"] = card_vs_cpu_phase(
            tr, init1, tmp, fixed["real_images"][:CMP_BATCH], card)
        for p in clis.values():  # the timed runs below run alone
            p["waiter"].join(600)
        del tr, init1
        torch.cuda.empty_cache()

        # 3. stage 2 from stage 1's checkpoint; 4. the checkerboard
        for label, name in (("stage2", "endurance_stage2.yaml"),
                            ("cb_stage2", "cb_stage2.yaml")):
            cfg = train_config(name, tmp, label, total_iter=SHORT_STEPS,
                               pretrained_weight_path=ckpt1)
            tr, res[label], _, rates, counts[f"train {label}"], _ = \
                train_run(f"{label} ({name})", cfg, card, kernels)
            got = tr.pretrained_counts
            n_new = sum(1 for k in tr.comp_model.state_dict()
                        if ".interp_ca_list." in k or "spatial_transforms_"
                        in k)
            print(f"train {label}: the stage handoff loaded {got['loaded']} "
                  f"tensors of stage 1's {n_stage1}, kept {got['kept']} at "
                  f"init (InterpCA / spatial context: {n_new}); rate_ind "
                  f"sampled {rates}")
            check(got == {"loaded": n_stage1, "kept": n_new} and n_new > 0,
                  f"{label}: the handoff loaded {got}")
            levels = tr.comp_model.rate_level
            check(sorted(set(rates)) == [float(q) for q in range(levels)],
                  f"{label}: rate_ind {rates} does not span 0..{levels - 1}")
            res[label]["handoff"] = got
            del tr
            torch.cuda.empty_cache()

        # 5. the GDN model under the stage-1 recipe, f32
        cfg = train_config("endurance_stage1.yaml", tmp, "gdn",
                           total_iter=SHORT_STEPS, mixed_precision=False)
        bal = Config.from_file(os.path.join(ROOT, "config",
                                            "balle18_mean_scale.yaml"))
        cfg["model_type"], cfg["subnet"] = bal.model_type, bal.subnet
        tr, res["gdn"], _, _, counts["train gdn"], _ = train_run(
            "GDN (balle18_mean_scale.yaml, stage-1 recipe, f32)", cfg, card,
            kernels)
        check(counts["train gdn"]["gdn"] == 6 * SHORT_STEPS,
              f"GDN training: K3 launched {counts['train gdn']['gdn']} "
              f"times in {SHORT_STEPS} steps (6 a step expected)")
        gdns = [m for m in tr.comp_model.net.modules() if isinstance(m, GDN)]
        check(len(gdns) == 6 and all(
            p.grad is not None and bool(torch.isfinite(p.grad).all())
            and bool(p.grad.any()) for m in gdns for p in (m.beta, m.gamma)),
            "GDN training: a GDN parameter got no gradient (crdr::gdn)")
        print(f"train GDN: K3 {counts['train gdn']['gdn']} launches in "
              f"{SHORT_STEPS} steps; every GDN's beta and gamma has a "
              f"finite, non-zero gradient (through crdr::gdn's backward)")
        res["gdn"]["k3"] = k3_training_ms(card)
        del tr
        torch.cuda.empty_cache()

        # 6. resume; 7. the CLI
        res["resume"] = resume_check(tmp, card)
        torch.cuda.empty_cache()
        res["cli_s"] = cli_train_check(clis[1], card)
        res["phase_s"] = time.perf_counter() - t_phase
        print(f"training phase: {res['phase_s']:.1f} s [{card}]")

        # phase 16: stage 3 from stage 1's checkpoint, in this directory
        res["stage3"], counts["train stage3"] = gan_phase(
            card, tmp, ckpt1, kernels, clis[3], profiling)
    return res, counts


# ---------------- phase 16: stage 3, the GAN fine-tune ------------------------

GAN_STEPS = 12        # endurance_stage3.yaml through train_loop
GAN_RATE, GAN_BETA = 1.0, 2.56   # the controls of the card-vs-CPU step
TOP_RATE_STEPS = 6    # steps at each of the top rate and rate 1, in turns


def gan_step_flops(tr, data) -> float:
    """Model FLOPs of one stage-3 step, counted by forward hooks over one
    step: each conv call's forward FLOPs times 1 + (its input needs a
    gradient) + (its weight needs one), over the net (the G forward about
    3x, the no-grad anchor forward 1x), LPIPS (weights frozen: the real
    image 1x, the fake 2x) and D (its weights frozen in G's step: D(fake)
    2x, D(anchor) 1x; in D's step 3x, its first layer 2x)."""
    import torch

    from crdr_tpu_torch.nn import GDN, Conv2d, ConvTranspose2d

    total = {"net": 0.0, "lpips": 0.0, "d": 0.0}
    handles = []

    def hook(part):
        def count(m, inp, out):
            x = inp[0]
            if isinstance(m, GDN):
                f, w = 2 * x.numel() * m.gamma.shape[0], m.gamma
            elif isinstance(m, ConvTranspose2d):
                f, w = 2 * x.numel() * m.weight[0].numel(), m.weight
            else:
                f, w = 2 * out.numel() * m.weight[0].numel(), m.weight
            grad = torch.is_grad_enabled()
            total[part] += f * (1 + int(grad and x.requires_grad)
                                + int(grad and w.requires_grad))
        return count

    for part, root in (("net", tr.comp_model.net),
                       ("lpips", tr.perceptual_loss),
                       ("d", tr.discriminator)):
        handles += [m.register_forward_hook(hook(part)) for m in
                    root.modules()
                    if isinstance(m, (Conv2d, ConvTranspose2d, GDN))]
    try:
        tr.optimize_parameters_device(tr.step + 1, data)
    finally:
        for h in handles:
            h.remove()
    print("stage 3 model FLOPs a step: " + ", ".join(
        f"{k} {v / 1e12:.4f} TFLOP" for k, v in total.items()))
    return sum(total.values())


def gan_handoff(tr, cfg, ckpt1: str) -> dict:
    """The stage-1 -> stage-3 partial merge against the checkpoint's own
    names and shapes, and D at its seeded init."""
    import torch

    from crdr_tpu_torch.subnet.discriminator import build_discriminator

    stage1 = torch.load(ckpt1, map_location="cpu",
                        weights_only=True)["comp_model"]
    own = tr.comp_model.state_dict()
    same = [k for k in own if k in stage1
            and tuple(stage1[k].shape) == tuple(own[k].shape)]
    kept = sorted(set(own) - set(same))
    new_mods = sorted({".".join(k.split(".")[:2]) for k in kept})
    got = tr.pretrained_counts
    print(f"train stage3: the stage handoff loaded {got['loaded']} tensors "
          f"(stage 1's checkpoint has {len(stage1)}, {len(same)} of them "
          f"with the flagship's names and shapes), kept {got['kept']} at init "
          f"in {new_mods}")
    check(got == {"loaded": len(same), "kept": len(kept)} and len(same) > 0,
          f"stage 3: the handoff loaded {got}, expected {len(same)} / "
          f"{len(kept)}")
    check(all("interp_ca" in k or k.startswith("decoder.") for k in kept)
          and any("interp_ca" in k for k in kept),
          f"stage 3: tensors outside the InterpCA / beta modules kept at "
          f"init: {[k for k in kept if 'interp_ca' not in k][:8]}")
    seed = int(cfg.get("seed", 0))
    with tr.device:
        fresh = build_discriminator(cfg.discriminator, torch.Generator(
            device=tr.device).manual_seed(seed + 1))
    mine = tr.discriminator.state_dict()
    check(all(torch.equal(v, mine[k]) for k, v in fresh.state_dict().items()),
          "stage 3: D is not at its seeded init")
    n_d = sum(v.numel() for v in mine.values())
    print(f"train stage3: D ({cfg.discriminator.type}, "
          f"{len(tr.discriminator.subD_list)} sub-Ds, {n_d / 1e6:.2f}M "
          "params) equal to its seeded init (seed + 1)")
    return {**got, "stage1_tensors": len(stage1), "new_modules": new_mods,
            "d_params": n_d}


def gan_run(cfg, card: str, kernels: dict, ckpt1: str):
    """Phase 16's steps: build, the handoff, GAN_STEPS through train_loop
    with the kernel counts set to 0 just before and read after.  Returns
    (trainer, stats, {kernel: launches}, G's and D's seeded init on the
    CPU)."""
    import torch

    from crdr_tpu_torch.trainer import build_trainer

    t0 = time.perf_counter()
    tr = build_trainer(cfg)  # the GPU
    print(f"train stage3: {type(tr).__name__}, {cfg.model_type} built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in tr.comp_model.net.parameters()) / 1e6:.1f}"
          f"M params")
    check(tr.comp_model.device.type == "cuda", "stage 3: not on the card")
    res = {"handoff": gan_handoff(tr, cfg, ckpt1)}
    init = ({k: v.detach().cpu().clone()
             for k, v in tr.comp_model.state_dict().items()},
            {k: v.detach().cpu().clone()
             for k, v in tr.discriminator.state_dict().items()})
    subs = list(tr.discriminator.subD_list)
    sub0 = [[p.detach().clone() for p in sd.parameters()] for sd in subs]
    logs, times, rates = record_steps(tr)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    tr.train_loop()
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    last = check_logs(logs, "stage 3")
    print(f"train stage3: {len(logs)} steps, all losses finite, none "
          f"skipped; last step " + ", ".join(
              f"{k} {v:.4f}" for k, v in last.items()) + f"; launches {counts}")
    levels = tr.comp_model.rate_level
    check(sorted(set(rates)) == [float(q) for q in range(levels)],
          f"stage 3: rate_ind {rates} does not span 0..{levels - 1}")
    moved = [any(not torch.equal(a, b) for a, b in zip(p0, sd.parameters()))
             for p0, sd in zip(sub0, subs)]
    sampled = [float(i) in rates for i in range(len(subs))]
    print(f"train stage3: rate_ind sampled {rates}; sub-D moved {moved}")
    check(any(moved) and moved == sampled, f"stage 3: the sub-Ds moved "
          f"{moved}, their rates were sampled {sampled}")
    d_real = torch.stack([log["out_d_real"] for log in logs]).cpu().tolist()
    d_fake = torch.stack([log["out_d_fake"] for log in logs]).cpu().tolist()
    sep = [r - f for r, f in zip(d_real, d_fake)]
    res["d_health"] = {
        "out_d_real": d_real, "out_d_fake": d_fake,
        "separation_first5": float(np.mean(sep[:5])),
        "separation_last5": float(np.mean(sep[-5:]))}
    print(f"train stage3: D's health, out_d_real {[round(v, 4) for v in d_real]}"
          f", out_d_fake {[round(v, 4) for v in d_fake]}; mean separation "
          f"(real - fake) first 5 {res['d_health']['separation_first5']:.4f}"
          f", last 5 {res['d_health']['separation_last5']:.4f}")
    res.update(train_stats("stage3 (endurance_stage3.yaml)", cfg,
                           list(times), gan_step_flops(
                               tr, next(iter(tr.train_loader))), peak, card))
    res["rates"] = rates
    return tr, res, counts, init


def gan_top_rate(tr, data, card: str) -> dict:
    """Steps at the top rate (the anchor is the batch: one net forward) and
    at rate 1 (the anchor forward first: two), in turns, each timed."""
    import torch

    forwards = []
    hook = tr.comp_model.net.register_forward_hook(
        lambda *a: forwards.append(1))
    saved = tr.sample_controls
    top = float(tr.comp_model.rate_level - 1)
    res = {f"rate {r:g}": {"forwards": 0, "runs_ms": []} for r in (top, 1.0)}
    try:
        for _ in range(TOP_RATE_STEPS):
            for rate in (top, 1.0):
                tr.sample_controls = lambda itr, r=rate: (r, GAN_BETA,
                                                          (1.0, 1.0))
                n0 = len(forwards)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.optimize_parameters_device(tr.step + 1, data)
                torch.cuda.synchronize()
                row = res[f"rate {rate:g}"]
                row["runs_ms"].append((time.perf_counter() - t0) * 1e3)
                row["forwards"] += len(forwards) - n0
    finally:
        hook.remove()
        tr.sample_controls = saved
    for row in res.values():
        row["forwards_per_step"] = row.pop("forwards") / TOP_RATE_STEPS
        row["ms"] = float(np.median(row["runs_ms"]))
    print("train stage3, the anchor, in turns: " + "; ".join(
        f"{k}: {v['forwards_per_step']:g} net forwards a step, median "
        f"{v['ms']:.1f} ms ({[round(t, 1) for t in v['runs_ms']]})"
        for k, v in res.items()) + f" [{card}]")
    check(res[f"rate {top:g}"]["forwards_per_step"] == 1
          and res["rate 1"]["forwards_per_step"] == 2,
          f"stage 3: net forwards a step {res}: the top rate's anchor must "
          "be the batch")
    return res


def gan_grads(tr, batch, noise, dtype=None, gates=None):
    """One stage-3 step's G and D halves at GAN_RATE / GAN_BETA in
    ``dtype`` (f32 by default; the trainer's net, LPIPS and D already in
    it), no update: the losses of both, the gradients of G (``G.``) and D
    (``D.``) as float64 on the CPU, the quantized latents and, with
    ``gates``, that mode's record.  The forwards run under ``gates``."""
    import contextlib

    net, d = tr.comp_model.net, tr.discriminator
    net.zero_grad(set_to_none=True)
    d.zero_grad(set_to_none=True)
    saved, tr.comp_model.noise = tr.comp_model.noise, noise
    try:
        x = tr.put_batch(batch)
        x = x.to(dtype or x.dtype)
        with gates if gates is not None else contextlib.nullcontext():
            total, losses, out, _ = tr.gan_g_losses(x, GAN_RATE, GAN_BETA)
            dl = tr.gan_d_losses(x, out["fake_images"].detach(),
                                 out["quantized_code"]["y"].detach(),
                                 GAN_RATE)
        total.backward()
        dl["d_total"].backward()
    finally:
        tr.comp_model.noise = saved
    grads = {f"{tag}.{n}": p.grad.detach().double().cpu()
             for tag, mod in (("G", net), ("D", d))
             for n, p in mod.named_parameters() if p.grad is not None}
    net.zero_grad(set_to_none=True)
    d.zero_grad(set_to_none=True)
    vals = {k: float(v.detach()) for k, v in
            {**losses, "total": total, **dl}.items()}
    return vals, grads, {k: v.detach().cpu() for k, v in
                         out["quantized_code"].items()}, \
        gates.rec if gates is not None else None


def gan_card_vs_cpu(tr, init, tmp: str, ckpt1: str, batch, card: str) -> dict:
    """At the seeded stage-3 init (stage 1's trunk, the new modules and D at
    init), the same weights, batch, controls and noise through one f32 step
    (TF32 off, mixed precision off) on the card and on the CPU, and a
    float64 CPU step as the reference: every pair's losses within
    TRAIN_RTOL; with the (leaky) ReLUs and max pools held to the float64
    step's gates and picks, the card and the f32 CPU each within TRAIN_RTOL
    and GRAD_REL of it and of each other; with free gates a gradient past
    GRAD_REL passes only where some gate differs (phase 15's rule)."""
    import torch

    from crdr_tpu_torch.trainer import build_trainer

    cpu = build_trainer(train_config(
        "endurance_stage3.yaml", tmp, "s3cpu", mixed_precision=False,
        pretrained_weight_path=ckpt1), device="cpu")
    for t in (cpu, tr):
        t.comp_model.load_state_dict(init[0], strict=True)
        t.discriminator.load_state_dict(init[1], strict=True)
    cpu.perceptual_loss.load_state_dict(
        {k: v.cpu() for k, v in tr.perceptual_loss.state_dict().items()})
    drawn, g = [], torch.Generator().manual_seed(1)

    def record(name, like):
        drawn.append(torch.rand(like.shape, generator=g,
                                dtype=torch.float32) - 0.5)
        return drawn[-1].to(like.dtype)

    def replay():
        it = iter(drawn)
        return lambda name, like: next(it).to(like.device, like.dtype)

    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             tr.opt.get("mixed_precision"))
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    tr.opt["mixed_precision"] = False
    try:
        t0 = time.perf_counter()
        free = {"cpu": gan_grads(cpu, batch, record, gates=gate_replay())}
        cpu_s = time.perf_counter() - t0
        free["card"] = gan_grads(tr, batch, replay(), gates=gate_replay())
        for m in (cpu.comp_model.net, cpu.perceptual_loss, cpu.discriminator):
            m.double()
        t0 = time.perf_counter()
        ref = gan_grads(cpu, batch, replay(), torch.float64, gate_replay())
        f64_s = time.perf_counter() - t0
        for m in (cpu.comp_model.net, cpu.perceptual_loss, cpu.discriminator):
            m.float()
        held = {"card": gan_grads(tr, batch, replay(),
                                  gates=gate_replay(ref[3])),
                "cpu": gan_grads(cpu, batch, replay(),
                                 gates=gate_replay(ref[3]))}
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
         tr.opt["mixed_precision"]) = saved
    zero = zero_by_construction(tr, [*free.values(), ref, *held.values()])
    rows = {
        "card vs CPU f32, free": step_row(free["card"], free["cpu"]),
        "card vs f64, free": step_row(free["card"], ref),
        "CPU f32 vs f64, free": step_row(free["cpu"], ref),
        "card vs f64, gates held": step_row(held["card"], ref),
        "CPU f32 vs f64, gates held": step_row(held["cpu"], ref),
        "card vs CPU f32, gates held": step_row(held["card"], held["cpu"])}
    apart = {"card vs CPU f32": gates_apart(free["card"][3], free["cpu"][3]),
             "card vs f64": gates_apart(free["card"][3], ref[3]),
             "CPU f32 vs f64": gates_apart(free["cpu"][3], ref[3])}
    calls = {k: len(v) for k, v in ref[3].items()}
    print(f"stage 3 card vs CPU, seeded stage-3 init, rate {GAN_RATE:g}, "
          f"beta {GAN_BETA}, batch {CMP_BATCH}: the f32 CPU step {cpu_s:.1f} "
          f"s, the float64 CPU step {f64_s:.1f} s; gate calls {calls}; gates "
          f"set apart (elements; [call, shape, elements]) {apart}; zero by "
          f"construction {zero}")
    for what, row in rows.items():
        print(say_row(f"  {what}", row) + f" [{card}]")

    def holds(row, what):
        check(row["max_loss_rel"] <= TRAIN_RTOL, f"stage 3, {what}: losses "
              f"differ by {row['max_loss_rel']:.3e} (rtol {TRAIN_RTOL})")
        check(row["max_grad_rel_l2"] <= GRAD_REL, f"stage 3, {what}: gradient "
              f"{row['worst']} off by {row['max_grad_rel_l2']:.3e} (relative "
              f"L2, limit {GRAD_REL})")

    for what in ("card vs f64, gates held", "CPU f32 vs f64, gates held",
                 "card vs CPU f32, gates held"):
        holds(rows[what], what)
    for what, pair in (("card vs CPU f32, free", "card vs CPU f32"),
                       ("card vs f64, free", "card vs f64"),
                       ("CPU f32 vs f64, free", "CPU f32 vs f64")):
        check(rows[what]["max_loss_rel"] <= TRAIN_RTOL, f"stage 3, {what}: "
              f"losses differ by {rows[what]['max_loss_rel']:.3e}")
        check(not rows[what]["over_limit"] or any(
            v["elements"] for v in apart[pair].values()),
            f"stage 3, {what}: gradients {rows[what]['over_limit']} differ "
            "past the limit with every gate set alike")
    del cpu
    return {**{k: {x: r[x] for x in ("max_loss_rel", "max_grad_rel_l2",
                                     "worst", "over_limit")}
               for k, r in rows.items()},
            "gates_apart": apart, "gate_calls": calls, "cpu_f32_s": cpu_s,
            "cpu_f64_s": f64_s, "zero_by_construction": zero}


def zero_by_construction(tr, steps) -> dict:
    """Takes out of each gan_grads result the gradients that are 0 by
    construction, and checks them there: under RGAN, D's loss is
    f(D(real) - D(fake)) + g(D(fake) - D(real)) with f' = -g' at every
    pixel, so the last conv's bias (in both halves) gets none; rounding
    leaves ~1e-9, which a relative error cannot judge.  Each must be within
    1e-3 of the largest D gradient's norm.  Returns {name: the largest
    ratio}."""
    import torch

    if tr.adv_mode != "rgan":
        return {}
    out = {}
    for step in steps:
        grads = step[1]
        top = max(float(torch.linalg.vector_norm(v)) for k, v in
                  grads.items() if k.startswith("D."))
        for name in [k for k in grads if k.startswith("D.")
                     and k.endswith("head.bias")]:
            ratio = float(torch.linalg.vector_norm(grads.pop(name))) / top
            out[name] = max(out.get(name, 0.0), ratio)
            check(ratio <= 1e-3, f"stage 3: {name}'s gradient, 0 by "
                  f"construction under RGAN, is {ratio:.3e} of the largest")
    return out


def gan_resume_check(tmp: str, ckpt1: str, card: str) -> dict:
    """Save at step k, rebuild from the checkpoint, run to 2k on the same
    batches: G, D (parameters and state), the three optimizers and the
    generators bit-equal to the uninterrupted run's."""
    import torch

    from crdr_tpu_torch.data import cycle
    from crdr_tpu_torch.trainer import build_trainer

    k = RESUME_K

    def cfg(**over):
        return train_config("endurance_stage3.yaml", tmp, "s3resume",
                            pretrained_weight_path=ckpt1, **over)

    a = build_trainer(cfg())
    data = [d for _, d in cycle(a.train_loader, 0, 2 * k)]
    for i in range(k):
        a.optimize_parameters_device(i + 1, data[i])
    a.save(k)
    check(os.path.exists(a.path_handler.get_ckpt_path("discriminator", k)),
          "stage 3: no discriminator checkpoint written")
    for i in range(k, 2 * k):
        a.optimize_parameters_device(i + 1, data[i])
    b = build_trainer(cfg(start_iter=k))
    for i in range(k, 2 * k):
        b.optimize_parameters_device(i + 1, data[i])
    torch.cuda.synchronize()
    pairs = [(f"G {n}", p.detach(), q.detach()) for (n, p), (_, q) in
             zip(a.comp_model.net.named_parameters(),
                 b.comp_model.net.named_parameters())]
    pairs += [(f"D {n}", p, q) for (n, p), (_, q) in
              zip(a.discriminator.state_dict().items(),
                  b.discriminator.state_dict().items())]
    for label, oa, ob in (("g", a.g_opt, b.g_opt), ("aux", a.aux_opt,
                                                     b.aux_opt),
                          ("d", a.d_opt, b.d_opt)):
        pairs += [(f"{label} {key}", oa.state[key], ob.state[key])
                  for key in oa.state]
    pairs.append(("noise generator", a.noise.generator.get_state(),
                  b.noise.generator.get_state()))
    diff = {name: float((x.double() - y.double()).abs().max())
            for name, x, y in pairs if not torch.equal(x, y)}
    same_np = a.comp_model.sample_rate_ind() == b.comp_model.sample_rate_ind()
    worst = max(diff.items(), key=lambda kv: kv[1]) if diff else (None, 0.0)
    print(f"stage 3 resume: saved at step {k}, rebuilt from the checkpoint, "
          f"run to {2 * k}: {len(pairs) - len(diff)} of {len(pairs)} tensors "
          f"(G, D and its state, the G / aux / D optimizers, the noise "
          f"generator) bit-equal to the uninterrupted run's, the numpy "
          f"generator {'equal' if same_np else 'NOT equal'}; largest "
          f"difference {worst[1]:.3e} ({worst[0]}) [{card}]")
    check(not diff and same_np, f"stage 3 resume is not bit-equal: "
          f"{len(diff)} tensors differ, the largest by {worst[1]:.3e} "
          f"({worst[0]})")
    del a, b
    return {"tensors": len(pairs), "differing": len(diff)}


def gan_cli_check(p: dict, card: str) -> float:
    """The stage-3 run of ``train_cli_start``, warm-started from phase 15's
    stage-1 checkpoint: it writes its checkpoints (D's included) and its
    loss CSV."""
    steps, cmd = CLI_STEPS, p["cmd"]
    rc, log, dt = end_proc(p)
    check(rc == 0, f"the stage-3 train CLI exited {rc}:\n{log[-6000:]}")
    check("partial load" in log,
          "the stage-3 train CLI did not warm-start from stage 1")
    job = os.path.join(p["cwd"], "checkpoint", "endurance_stage3")
    for name in (f"comp_model_iter{steps}.ckpt",
                 f"training_state_iter{steps}.ckpt",
                 f"discriminator_iter{steps}.ckpt"):
        check(os.path.exists(os.path.join(job, "model", name)),
              f"the stage-3 train CLI wrote no {name}")
    with open(os.path.join(job, "log_loss.csv")) as f:
        rows = f.read().strip().splitlines()
    check(len(rows) == steps + 1 and "out_d_real" in rows[0],
          f"the stage-3 train CLI's log_loss.csv: {rows}")
    print(f"train CLI: {' '.join(cmd[1:3])} endurance_stage3.yaml -ti "
          f"{steps}: {dt:.1f} s (process start and model build included; "
          f"beside phase 15's card-vs-CPU step and the stage-1 CLI), "
          f"warm-started from stage 1, "
          f"checkpoints (D's included) and {steps} loss rows written "
          f"[{card}]")
    return dt


def gan_phase(card: str, tmp: str, ckpt1: str, kernels: dict, cli: dict,
              profiling: bool = False):
    """Phase 16: stage 3 on the card at full width, in phase 15's temporary
    directory, from its stage-1 checkpoint ``ckpt1``; ``cli`` is the
    stage-3 CLI run of ``train_cli_start``."""
    import torch

    t_phase = time.perf_counter()
    cfg = train_config("endurance_stage3.yaml", tmp, "stage3",
                       total_iter=GAN_STEPS, pretrained_weight_path=ckpt1)
    tr, res, counts, init = gan_run(cfg, card, kernels, ckpt1)
    fixed = next(iter(tr.train_loader))
    if profiling:
        profile_phase(lambda: [tr.optimize_parameters_device(
            tr.step + 1, fixed) for _ in range(3)],
            "stage 3 training, 3 steps", card)
    res["anchor"] = gan_top_rate(tr, fixed, card)
    res["card_vs_cpu"] = gan_card_vs_cpu(
        tr, init, tmp, ckpt1, fixed["real_images"][:CMP_BATCH], card)
    del tr, init
    torch.cuda.empty_cache()
    res["resume"] = gan_resume_check(tmp, ckpt1, card)
    torch.cuda.empty_cache()
    res["cli_s"] = gan_cli_check(cli, card)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"stage 3 phase: {res['phase_s']:.1f} s [{card}]")
    return res, counts


# ---------------- phase 17: streams across devices ---------------------------

# config, what differs between the card and the CPU (printed beside it)
# phase 17's image: a 256x384 crop of the phases' first image (the CPU's
# full-width passes at 512x768 took most of the phase's minute)
CROSS_H, CROSS_W = 256, 384
CROSS_CONFIGS = (
    ("crdr.yaml", "f32 flagship, K1 off, f32 chain on both"),
    ("balle18_mean_scale.yaml", "GDN path: K3 on the card, gdn_plain on the "
                                "CPU"),
    ("crdr_throughput.yaml", "bf16 transforms: K1 on the card, its bf16 "
                             "twin on the CPU"),
    ("crdr_fastchain.yaml", "TF32 chain on the card (none on a CPU), K1 / "
                            "its twin"),
)


def latent_order(model, y_hat) -> np.ndarray:
    """NHWC y_hat [1, h, w, C] -> [slices, slice_ch * h * w]: each slice's
    symbols in the channel-major order the compressai wire codes them (the
    generic family is one slice)."""
    y = np.asarray(y_hat)[0].transpose(2, 0, 1)  # [C, h, w]
    ns = model.num_slices if model.use_charm else 1
    return y.reshape(ns, -1)


def first_where(mask: np.ndarray):
    """(slice, index) of the first True of a [slices, n] mask, or None."""
    hits = np.argwhere(mask)
    return None if len(hits) == 0 else tuple(int(v) for v in hits[0])


def compare_latents(model, a, b) -> dict:
    """Two y_hat of one image: bit-equal or not, the largest difference, the
    first element apart (slice, index) and the first symbol apart (a
    difference of half a bin or more: y_hat = symbol + mu, so a mu a few
    ulps apart moves y_hat by ulps and a symbol apart by about a bin)."""
    a, b = latent_order(model, a), latent_order(model, b)
    diff = np.abs(a.astype(np.float64) - b)
    return {"equal": bool(np.array_equal(a, b)),
            "max_abs_diff": float(diff.max()),
            "first_diff": first_where(diff > 0),
            "symbols_apart": int((diff >= 0.5).sum()),
            "first_symbol": first_where(diff >= 0.5)}


def first_byte_apart(a: bytes, b: bytes):
    n = min(len(a), len(b))
    diff = np.flatnonzero(np.frombuffer(a[:n], np.uint8)
                          != np.frombuffer(b[:n], np.uint8))
    if len(diff):
        return int(diff[0])
    return None if len(a) == len(b) else n


def cross_decode(model, enc, label: str) -> dict:
    """Decode another device's stream: y_hat against that encoder's, or the
    exception it raised (a measured outcome, never a skip)."""
    kw = {"beta": BETA} if model.use_beta else {}
    try:
        _, _, y_hat = model.decompress(enc["string_list"], **kw)
    except Exception as e:  # the outcome is reported, the phase goes on
        res = {"raised": f"{type(e).__name__}: {e}"}
    else:
        res = compare_latents(model, y_hat, enc["y_hat"])
    print(f"  {label}: {json.dumps(res)}")
    return res


def cross_device_config(name: str, what: str, img, card: str) -> dict:
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import Config

    cfg_path = os.path.join(ROOT, "config", name)
    if name == "balle18_mean_scale.yaml":
        gpu = build_gdn_model(img, card)
    else:
        gpu = build_comp_model(Config.from_file(cfg_path))
        raise_y_scales(gpu)
        gpu.codec_setup()
    cpu = build_comp_model(Config.from_file(cfg_path), device="cpu")
    cpu.load_state_dict(gpu.state_dict(), strict=True)
    cpu.codec_setup()
    enc_kw = {"rate_ind": RATE} if gpu.use_rate else {}
    dec_kw = {"beta": BETA} if gpu.use_beta else {}

    enc_g = gpu.compress(img, **enc_kw)
    _, _, y_g = gpu.decompress(enc_g["string_list"], **dec_kw)
    check(np.array_equal(y_g, enc_g["y_hat"]),
          f"{name}: the card's own round trip is not exact")
    t0 = time.perf_counter()
    enc_c = cpu.compress(img, **enc_kw)
    cpu_enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, y_c = cpu.decompress(enc_c["string_list"], **dec_kw)
    cpu_dec_s = time.perf_counter() - t0
    check(np.array_equal(y_c, enc_c["y_hat"]),
          f"{name}: the CPU's own round trip is not exact")

    sg, sc = enc_g["string_list"], enc_c["string_list"]
    res = {"config": name, "what": what,
           "streams_equal": sg == sc,
           "y_first_byte_apart": first_byte_apart(sg[2], sc[2]),
           "y_bytes": [len(sg[2]), len(sc[2])],
           "encoders_y_hat": compare_latents(gpu, enc_g["y_hat"],
                                             enc_c["y_hat"])}
    print(f"cross-device {name} ({what}), one {img.shape[2]}x{img.shape[1]} "
          f"image: streams byte-equal {res['streams_equal']}, first y byte "
          f"apart {res['y_first_byte_apart']} (y strings {res['y_bytes']} "
          f"bytes, card / CPU); encoders' y_hat "
          f"{json.dumps(res['encoders_y_hat'])}; each device's own round "
          f"trip exact")
    t0 = time.perf_counter()
    res["card_stream_on_cpu"] = cross_decode(
        cpu, enc_g, "the card's stream decoded on the CPU")
    cpu_cross_s = time.perf_counter() - t0
    res["cpu_stream_on_card"] = cross_decode(
        gpu, enc_c, "the CPU's stream decoded on the card")
    res["cpu_s"] = {"encode": cpu_enc_s, "decode": cpu_dec_s,
                    "cross_decode": cpu_cross_s}
    print(f"  CPU seconds ({torch.get_num_threads()} threads): encode "
          f"{cpu_enc_s:.1f}, decode {cpu_dec_s:.1f}, the card's stream "
          f"{cpu_cross_s:.1f} [{card}]")
    del gpu, cpu
    torch.cuda.empty_cache()
    return res


def cross_device_phase(img, card: str) -> list:
    """Phase 17: each of CROSS_CONFIGS built once from its seed on the card
    and, from the card's state_dict, on the CPU; one image encoded on each,
    each device's own round trip asserted exact, and each stream decoded on
    the other device.  The outcomes are measured and printed, not asserted:
    the port does not promise streams across devices."""
    t0 = time.perf_counter()
    rows = [cross_device_config(name, what, img, card)
            for name, what in CROSS_CONFIGS]
    print("cross_device " + json.dumps(rows))
    print(f"cross-device phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return rows


# ---------------- phase 18: serving on the card ----------------------------

SERVE_QS = (0.0, 1.5, 2.0, 3.25, 4.0)
SERVE_BETAS = (0.0, 1.28, 2.56, 5.12)
SERVE_CLIENTS, SERVE_WAVES = 8, 3
SMALL_CLIENTS = (6, 7)  # these two send 256x384 images


# where the codec calls each kernel's wrapper, and the shape a served call
# is sampled by: K1 x's [N, H, W, Cin]; K2 the states' [N, K] and the
# round's steps; E1 the symbols' [N, M] and the lane grid; K3 x and the
# direction
SERVED_SITES = {
    "slice_transform": ("crdr_tpu_torch.ops.charm_uniform",
                        lambda a: tuple(a[0].shape)),
    "lane_decode_round": ("crdr_tpu_torch.models.codec_devicewire",
                          lambda a: (tuple(a[0].shape), a[5])),
    "lane_encode_rounds": ("crdr_tpu_torch.models.codec_devicewire",
                           lambda a: (tuple(a[0].shape), tuple(a[2].shape))),
    "gdn": ("crdr_tpu_torch.nn.norm", lambda a: (tuple(a[0].shape), a[3])),
}


@contextlib.contextmanager
def sampled_kernel_calls():
    """Within the block, keeps the first call of each kernel at each shape
    (``SERVED_SITES``): {kernel: {shape: (arguments, output)}}, tensors
    cloned (a tensor passed again unchanged, as the weight stacks are, is
    cloned once).  Every call runs, and counts, as it would.  The clones'
    bytes are under the key "bytes"."""
    import torch

    copies = {}

    def clone(v):
        if torch.is_tensor(v):
            # v is held beside its clone, so its memory is not reused
            # and its pointer and version name these contents
            key = (v.data_ptr(), v._version, v.shape, v.stride(), v.dtype)
            if key not in copies:
                v = v.detach()  # a training call's: no graph is kept
                copies[key] = (v, v.clone())
                samples["bytes"] += 2 * v.numel() * v.element_size()
            return copies[key][1]
        return tuple(map(clone, v)) if type(v) is tuple else v

    samples, saved = {name: {} for name in SERVED_SITES}, []
    samples["bytes"] = 0
    for name, (where, shape_of) in SERVED_SITES.items():
        mod = importlib.import_module(where)
        real = getattr(mod, name)

        def sampler(*args, _real=real, _shape_of=shape_of,
                    _into=samples[name]):
            key = _shape_of(args)
            if key in _into:
                return _real(*args)
            kept = clone(args)
            out = _real(*args)
            _into[key] = (kept, clone(out))
            return out

        saved.append((mod, name, real))
        setattr(mod, name, sampler)
    try:
        yield samples
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def hold_served_kernels(samples, label: str, card: str) -> dict:
    """Each sampled served call's output against the kernel's plain twin on
    the same inputs: K1 within K1_ATOL, K2 and E1 exactly, K3 within
    K3_RTOL |plain| + K3_ATOL.  Returns {kernel: shapes held}."""
    import torch

    from crdr_tpu_torch.ops import device_rans
    from crdr_tpu_torch.ops.gdn import gdn_plain
    from crdr_tpu_torch.ops.slice_transform import slice_transform_plain

    def k1(args, out):
        x, *stacks, idx = args
        plain = slice_transform_plain(x, *(t[idx] for t in stacks))
        err = float((out - plain).abs().max())
        return bool(torch.isfinite(out).all()) and err <= K1_ATOL, err

    def k2(args, out):
        st, pt, words, idx, table, m = args
        ref = device_rans.lane_decode_round_instep(
            st, pt, words, idx, table.cdf, table.cdf_len, table.cdf_off, m)
        return all(torch.equal(a, b) for a, b in zip(out, ref)), 0

    def e1(args, out):
        ref = device_rans.lane_encode_rounds(*args[:8])  # to perm
        return all(torch.equal(a, b) for a, b in zip(out, ref)), 0

    def k3(args, out):
        ref = gdn_plain(*args)
        excess = float(((out - ref).abs() / (K3_RTOL * ref.abs() + K3_ATOL))
                       .max())
        return excess <= 1.0, float((out - ref).abs().max())

    twins = {"slice_transform": k1, "lane_decode_round": k2,
             "lane_encode_rounds": e1, "gdn": k3}
    held = {}
    for name, twin in twins.items():
        for key, (args, out) in samples[name].items():
            ok, err = twin(args, out)
            check(ok, f"{label}: served {name} at {key} != its plain twin "
                      f"(max |err| {err:.3e})")
            row = held.setdefault(name, {"shapes": [], "max_abs_err": 0.0})
            row["shapes"].append(str(key))
            row["max_abs_err"] = max(row["max_abs_err"], err)
    print(f"{label}: each kernel's served calls held against its plain twin "
          f"at every shape the traffic gave it (K1 within {K1_ATOL}, K2 and "
          f"E1 exactly, K3 within {K3_RTOL} |plain| + {K3_ATOL}): {held} "
          f"[{card}]")
    return held


def corrupt_y(blob: bytes, how: str) -> bytes:
    """A .bin whose header and z string are intact and whose y string is
    cut to half (``cut``) or has its second half's bytes flipped
    (``flip``)."""
    from crdr_tpu_torch.utils.codec_utils import (pack_byte_strings,
                                                  unpack_byte_strings)

    strings = unpack_byte_strings(blob)
    y = strings[2]
    half = len(y) // 2
    strings[2] = y[:half] if how == "cut" else \
        y[:half] + bytes(b ^ 0x5A for b in y[half:])
    return pack_byte_strings(strings)


def post_status(url: str, body: bytes) -> int:
    import urllib.error

    try:
        http_post(url, body)
    except urllib.error.HTTPError as e:
        e.read()
        return e.code
    return 200


def http_post(url: str, body: bytes, timeout: float = 300.0):
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read(), dict(r.headers), time.perf_counter() - t0


def serve_model(card: str, wire: str = None):
    """The flagship as the serve CLI builds it (crdr_throughput.yaml, the
    seeded init, --max_batch 8 --max_wait_ms 10, every kernel library of
    its path built), then the y scales raised; returns (model, args)."""
    from crdr_tpu_torch.cli import serve as serve_cli

    args = serve_cli.parse_args(
        [os.path.join(ROOT, "config", "crdr_throughput.yaml"), "--port", "0",
         "--max_batch", "8", "--max_wait_ms", "10"]
        + (["--wire", wire] if wire else []))
    model = serve_cli.build_model(args)
    raise_y_scales(model)
    model.codec_setup()
    return model, args


def get_json(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def count_dispatches(model) -> list:
    """Wraps the model's batch entry points; returns the list each
    dispatch appends to: ("c", n, rate_ind) / ("d", n, beta, y strings)."""
    log = []
    enc, dec = model.compress_batch, model.decompress_batch

    def compress_batch(imgs, **kw):
        log.append(("c", len(imgs), kw.get("rate_ind")))
        return enc(imgs, **kw)

    def decompress_batch(lists, **kw):
        log.append(("d", len(lists), kw.get("beta"),
                    [sl[2] for sl in lists]))
        return dec(lists, **kw)

    model.compress_batch, model.decompress_batch = compress_batch, \
        decompress_batch
    return log


def expected_launches(model, log) -> dict:
    """Kernel launches of the logged dispatches: K1 3 a slice a direction,
    E1 2 an encode (device wire, device encoder), K2 a z round and a round
    a slice a decode (device wire), K3 3 a transform call of TRANSFORM_BATCH
    images (the GDN model)."""
    from crdr_tpu_torch.models.codec import TRANSFORM_BATCH
    from crdr_tpu_torch.nn import GDN

    gdn = any(isinstance(m, GDN) for m in model.net.modules())
    dev = model.wire_format == "device"
    want = {k: 0 for k in kernel_wrappers()}
    for kind, n, *_ in log:
        if model.use_charm and model.fused_slice_kernel:
            want["slice_transform"] += 3 * model.num_slices
        if gdn:
            want["gdn"] += 3 * -(-n // TRANSFORM_BATCH)
        if dev and kind == "c" and model.device_wire_encoder == "device":
            want["lane_encode_rounds"] += 2
        if dev and kind == "d":
            want["lane_decode_round"] += device_wire_expected(
                model, model.device_wire_encoder)["lane_decode_round"]
    return want


def serve_traffic(base: str, model, bodies, sizes, clients, waves,
                  last_wave: bool):
    """``clients`` threads, each ``waves`` waves of POST /compress (q from
    SERVE_QS), then each decompresses its streams (beta from SERVE_BETAS)
    and, with ``last_wave``, its first stream once more at beta 2.56.
    Returns (records, latencies by route, wall s)."""
    recs, lat, errors = [], {"compress": [], "decompress": []}, []
    lock = threading.Lock()

    def run(fn):
        threads = [threading.Thread(target=fn, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            check(not t.is_alive(), "a serving client hung")
        check(not errors, f"serving requests failed: {errors[:3]}")

    def guarded(fn):
        def body(i):
            try:
                fn(i)
            except Exception as e:  # reported by run(), then the phase fails
                with lock:
                    errors.append(f"client {i}: {type(e).__name__}: {e}")
        return body

    @guarded
    def compress(i):
        for w in range(waves):
            q = SERVE_QS[(i + w) % len(SERVE_QS)] if model.use_rate else None
            url = base + "/compress" + ("" if q is None else f"?q={q}")
            blob, headers, dt = http_post(url, bodies[i])
            if headers["X-CRDR-Wire"] != model.wire_format:
                raise ValueError(f"X-CRDR-Wire {headers['X-CRDR-Wire']}")
            with lock:
                recs.append({"client": i, "q": q, "bin": blob,
                             "size": sizes[i]})
                lat["compress"].append(dt)

    def decompress_one(rec, beta):
        url = base + "/decompress" + ("" if beta is None else
                                      f"?beta={beta}")
        png, headers, dt = http_post(url, rec["bin"])
        if headers["Content-Type"] != "image/png":
            raise ValueError(f"a {headers['Content-Type']} response")
        with lock:
            rec.setdefault("pngs", []).append((beta, png))
            lat["decompress"].append(dt)

    @guarded
    def decompress(i):
        mine = [r for r in recs if r["client"] == i]
        for w, rec in enumerate(mine):
            beta = SERVE_BETAS[(i + w) % len(SERVE_BETAS)] \
                if model.use_beta else None
            decompress_one(rec, beta)
        if last_wave:
            decompress_one(mine[0], 2.56 if model.use_beta else None)

    t0 = time.perf_counter()
    run(compress)
    run(decompress)
    return recs, lat, time.perf_counter() - t0


def serve_leg(model, args, label: str, bodies, imgs, sizes, clients: int,
              waves: int, last_wave: bool, card: str) -> dict:
    """One served leg (the checks of phase 18); returns its figures and
    the kernel launches of its served traffic."""
    import http.client

    import torch

    from crdr_tpu_torch.serving.http_server import make_server
    from crdr_tpu_torch.utils.codec_utils import unpack_byte_strings
    from crdr_tpu_torch.utils.img_utils import decode_png, tensor_to_uint8

    log = count_dispatches(model)
    srv = make_server(model, port=0, max_batch=args.max_batch,
                      max_wait_s=args.max_wait_ms / 1e3)
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        # warm-up round trip (cuDNN's first calls), not counted
        q = "?q=2.0" if model.use_rate else ""
        http_post(base + "/decompress", http_post(base + "/compress" + q,
                                                  bodies[0])[0])
        info = get_json(base + "/healthz")
        check(info.get("card") == torch.cuda.get_device_name(0) and
              info["devices"] == [str(model.device)],
              f"/healthz does not name the card: {info}")
        conn = http.client.HTTPConnection(*srv.server_address, timeout=120)
        conn.request("POST", "/compress" + q, body=b"\xff\xd8\xff\xe0JFIF")
        r = conn.getresponse()
        check(r.status == 400 and b"truncated data" in r.read(),
              f"{label}: a malformed JPEG body got {r.status}, not a 400")
        conn.request("POST", "/compress" + q, body=bodies[0])
        r = conn.getresponse()
        check(r.status == 200 and len(r.read()) > 0,
              f"{label}: the request after a bad JPEG on the same connection "
              f"got {r.status}")
        conn.close()
        stats0 = srv.batcher.stats()
        del log[:]

        kernels = kernel_wrappers()
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with sampled_kernel_calls() as samples:
            recs, lat, wall = serve_traffic(base, model, bodies, sizes,
                                            clients, waves, last_wave)
        counts = {n: k.launches for n, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        sampled = samples["bytes"] / 2**30
        stats = srv.batcher.stats()
        served = len(log)  # the dispatches of the served traffic

        # a .bin with a good header and a corrupt y string gets a 200
        # (garbage decoded: rANS does not detect it; K2 clamps its reads to
        # the stream) or a 400, never a hang; the server goes on serving
        beta = "?beta=2.56" if model.use_beta else ""
        corrupt = {how: post_status(base + "/decompress" + beta,
                                    corrupt_y(recs[0]["bin"], how))
                   for how in ("cut", "flip")}
        check(all(v in (200, 400) for v in corrupt.values()),
              f"{label}: corrupt y strings got {corrupt}")
        after = decode_png(http_post(base + "/decompress" + beta,
                                     recs[0]["bin"])[0])
        torch.cuda.synchronize()
    finally:
        srv.shutdown()
        srv.server_close()
    serving.join(30)
    check(not serving.is_alive() and not srv.batcher._worker.is_alive()
          and srv.batcher.stats()["queued"] == 0,
          f"{label}: the server did not shut down drained")
    del model.compress_batch, model.decompress_batch  # the class's again
    del log[served:]
    held = hold_served_kernels(samples, label, card)

    want = expected_launches(model, log)
    hist = {}
    for kind, n, *_ in log:
        hist.setdefault(kind, {}).setdefault(n, 0)
        hist[kind][n] += 1
    check(counts == want, f"{label}: kernel launches over the served "
                          f"traffic {counts}, expected {want} for the "
                          f"dispatches {hist}")
    check(stats["batches"] - stats0["batches"] == len(log),
          f"{label}: the batcher's count of dispatches != the model's")
    check(max(n for _, n, *_ in log) >= 2,
          f"{label}: no batch of 2 or more: {hist}")

    # every served .bin is the image's own stream; every served PNG the
    # stream's own decode (equal where the dispatch's betas were uniform:
    # asserted; mixed: printed, and asserted too, the synthesis running at
    # a fixed batch with a beta row per image)
    uniform = {}
    for entry in log:
        if entry[0] == "d":
            beta, ys = entry[2], entry[3]
            same = beta is None or np.ndim(beta) == 0
            for j, y in enumerate(ys):
                b = None if beta is None else float(np.float32(
                    beta if same else np.asarray(beta)[j]))
                # uniform only if every dispatch of it was
                uniform[(y, b)] = uniform.get((y, b), True) and same
    alone, mixed_diff = {}, 0
    for rec in recs:
        key = (rec["client"], rec["q"])
        if key not in alone:
            kw = {} if rec["q"] is None else {"rate_ind": rec["q"]}
            alone[key] = model.compress(imgs[rec["client"]], **kw)
        strings = unpack_byte_strings(rec["bin"])
        check(strings == alone[key]["string_list"],
              f"{label}: the served .bin of client {rec['client']} at q "
              f"{rec['q']} != compress of the image alone")
        for beta, png in rec["pngs"]:
            kw = {} if beta is None else {"beta": beta}
            fake, _, y_hat = model.decompress(strings, **kw)
            check(np.array_equal(y_hat, alone[key]["y_hat"]),
                  f"{label}: the decode of client {rec['client']}'s stream "
                  "gave other symbols than its encoder")
            want_img = tensor_to_uint8(fake[0])
            got = decode_png(png)
            diff = int(np.abs(got.astype(np.int16) - want_img).max())
            if uniform[(strings[2], None if beta is None
                        else float(np.float32(beta)))]:
                check(diff == 0, f"{label}: a served PNG (uniform-beta "
                                 f"dispatch) is {diff} levels from the "
                                 "stream's own decode")
            else:
                mixed_diff = max(mixed_diff, diff)
    last = [p for b, p in recs[0]["pngs"]
            if b == (2.56 if model.use_beta else None)][-1]
    check(np.array_equal(after, decode_png(last)),
          f"{label}: after the corrupt streams, a good one decoded to "
          "another image")
    n_req = sum(len(v) for v in lat.values())
    res = {"requests": n_req, "requests_per_s": n_req / wall,
           "corrupt_y_status": corrupt, "held_vs_twin": held,
           "wall_s": wall, "dispatches": hist,
           "batcher_hist": stats["batch_hist"],
           "mixed_beta_max_level_diff": mixed_diff,
           "peak_gib": peak, "sampled_calls_gib": sampled,
           "launches": counts,
           **{f"{route}_p{p}_ms": float(np.percentile(v, p)) * 1e3
              for route, v in lat.items() for p in (50, 95)}}
    print(f"served {label}: {n_req} requests in {wall:.2f} s "
          f"({res['requests_per_s']:.2f} req/s); compress p50 / p95 "
          f"{res['compress_p50_ms']:.1f} / {res['compress_p95_ms']:.1f} ms, "
          f"decompress {res['decompress_p50_ms']:.1f} / "
          f"{res['decompress_p95_ms']:.1f} ms; dispatches by size {hist}; "
          f"mixed-beta served vs alone: {mixed_diff} levels at most; peak "
          f"{peak:.2f} GiB ({sampled:.2f} GiB of it the kernels' sampled "
          f"calls); launches {counts}; corrupt y strings got "
          f"{corrupt}, the next request served [{card}]")
    check(mixed_diff == 0, f"{label}: a served mixed-beta PNG is "
                           f"{mixed_diff} levels from its own decode")
    return res


def serving_phase(card: str):
    """Phase 18: the flagship served on the compressai wire and the device
    wire (E1), then the GDN model; returns ({leg: figures}, {path:
    launches})."""
    import torch

    from crdr_tpu_torch.cli.serve_smoke import synthetic_images
    from crdr_tpu_torch.utils.img_utils import encode_png

    t0 = time.perf_counter()
    big = synthetic_images(SERVE_CLIENTS - len(SMALL_CLIENTS), IMG_H, IMG_W,
                           seed=21)
    small = synthetic_images(len(SMALL_CLIENTS), IMG_H // 2, IMG_W // 2,
                             seed=22)
    imgs = list(big) + list(small)
    sizes = [im.shape[:2] for im in imgs]
    bodies = [encode_png(im) for im in imgs]
    res, counts = {}, {}
    model, args = serve_model(card)
    for wire in ("compressai", "device"):
        if wire == "device":  # the default device encoder, E1
            model.opt["wire_format"] = "device"
            model.codec_setup()
            check(model.device_wire_encoder == "device",
                  "the device wire's default encoder is E1")
        label = f"flagship {wire} wire"
        res[label] = serve_leg(model, args, label, bodies, imgs, sizes,
                               SERVE_CLIENTS, SERVE_WAVES, True, card)
        counts[f"serve {wire}"] = res[label]["launches"]
    del model
    torch.cuda.empty_cache()
    gdn = build_gdn_model(np.stack(imgs[:1]), card)
    res["GDN model"] = serve_leg(gdn, args, "GDN model", bodies[:4],
                                 imgs[:4], sizes[:4], 4, 1, False, card)
    counts["serve gdn"] = res["GDN model"]["launches"]
    del gdn
    torch.cuda.empty_cache()
    print(f"serving phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return res, counts


# ---------------- phase 19: the evaluation protocol -------------------------

SWEEP_IMAGES = 2            # 512x768 images, each swept as one batch of 17
SWEEP_QS = [q * 0.25 for q in range(17)]
SWEEP_BETAS = (0.0, 3.84)
METRIC_IMAGES = 50          # the HiFiC FID protocol's minimum
# the metrics' networks on the card (f32, TF32 off) against the CPU: the
# largest |feature difference| over the largest |feature| (Inception pool3,
# cuDNN vs the CPU's convolutions summing in another order through ~90
# layers), and DISTS' value
INCEPTION_REL, DISTS_ATOL = 1e-3, 1e-4
# the FID of a feature set against itself, over the size of its terms
# (2 tr(sigma)): scipy's sqrtm of the product of two rank-deficient
# covariances (fewer patches than the 2048 features) is not exact; on the
# CPU, 100 patches of the seeded net gave -0.066 (about 1e-6 of the terms)
SELF_FID_REL = 1e-3
CARD = "cuda"               # the device of phases 19-21


@contextlib.contextmanager
def recorded_codec_calls():
    """Within the block, every ``compress_batch`` / ``decompress_batch`` of
    the port's models: [(model, method name, args, kwargs, result)]."""
    from crdr_tpu_torch.models.codec import CodecMixin

    calls, saved = [], {}
    for name in ("compress_batch", "decompress_batch"):
        real = saved[name] = getattr(CodecMixin, name)

        def rec(self, *args, _real=real, _name=name, **kw):
            out = _real(self, *args, **kw)
            calls.append((self, _name, args, kw, out))
            return out

        setattr(CodecMixin, name, rec)
    try:
        yield calls
    finally:
        for name, real in saved.items():
            setattr(CodecMixin, name, real)


def read_csv(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def sweep_check(calls, img_paths, label: str) -> None:
    """Each image's 17-image batch: every (image, q) stream equal to the
    image's batch-1 stream at q, every decode's y_hat its encoder's."""
    from crdr_tpu_torch.utils.img_utils import imread

    model = calls[0][0]
    encs = [out for _, name, _, _, out in calls if name == "compress_batch"]
    decs = [(kw.get("beta", args[1] if len(args) > 1 else 0.0), out)
            for _, name, args, kw, out in calls
            if name == "decompress_batch"]
    check(len(encs) == len(img_paths) and
          len(decs) == len(img_paths) * len(SWEEP_BETAS),
          f"{label}: {len(encs)} batch encodes and {len(decs)} batch "
          "decodes")
    for i, path in enumerate(img_paths):
        real = imread(path)[None]
        check(len(encs[i]) == len(SWEEP_QS), f"{label}: image {i}'s batch "
              f"holds {len(encs[i])} streams")
        for q, e in zip(SWEEP_QS, encs[i]):
            one = model.compress(real, rate_ind=q)
            check(one["string_list"] == e["string_list"],
                  f"{label}: image {i} at q {q}: its stream in the batch of "
                  f"{len(SWEEP_QS)} != its batch-1 stream")
        y_enc = np.concatenate([e["y_hat"] for e in encs[i]])
        for beta, (_, _, y_dec) in decs[i * len(SWEEP_BETAS):
                                         (i + 1) * len(SWEEP_BETAS)]:
            check(np.array_equal(y_dec, y_enc), f"{label}: image {i}'s "
                  f"decode at beta {beta} != its encoder's symbols")
    print(f"{label}: every (image, q) stream of the batches of "
          f"{len(SWEEP_QS)} equals the image's batch-1 stream at q; every "
          "decode gives its encoder's symbols")


def sweep_phase(card: str, tmp: str):
    """Phase 19 (a): ``python -m crdr_tpu_torch.cli.rd_sweep`` (its
    ``main``, in process) on crdr_throughput.yaml's seeded init (y scales
    raised, the rates spread), two 512x768 images, 17 qualities x betas 0
    and 3.84, on each wire.  Returns ({wire: CSV path}, {path: launches})."""
    import torch

    from crdr_tpu_torch.cli import rd_sweep
    from crdr_tpu_torch.cli.serve_smoke import synthetic_images
    from crdr_tpu_torch.utils.img_utils import write_png

    model = build_model(card)
    spread_rates(model)
    ckpt = os.path.join(tmp, "flagship.pth.tar")
    torch.save({"comp_model": model.state_dict()}, ckpt)
    del model
    torch.cuda.empty_cache()
    img_dir = os.path.join(tmp, "sweep_images")
    os.makedirs(img_dir)
    paths = []
    for i, img in enumerate(synthetic_images(SWEEP_IMAGES, IMG_H, IMG_W,
                                             19)):
        paths.append(os.path.join(img_dir, f"img{i}.png"))
        write_png(paths[-1], img)
    kernels = kernel_wrappers()
    csvs, counts = {}, {}
    n = SWEEP_IMAGES
    for wire in ("compressai", "device"):
        label = f"sweep {wire}"
        out = os.path.join(tmp, f"sweep_{wire}")
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with sampled_kernel_calls() as samples, \
                recorded_codec_calls() as calls:
            rd_sweep.main([os.path.join(ROOT, "config",
                                        "crdr_throughput.yaml"),
                           "--model_path", ckpt, "--img_dir", img_dir,
                           "--save_dir", out, "--wire", wire])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[label] = {name: k.launches for name, k in kernels.items()}
        dev = wire == "device"
        expected = {"slice_transform": 90 * n, "gdn": 0,
                    "lane_decode_round": 22 * n if dev else 0,
                    "lane_encode_rounds": 2 * n if dev else 0}
        check(counts[label] == expected, f"{label}: launches "
              f"{counts[label]} (expected {expected}: K1 30 a batch encode "
              "and decode, K2 11 a decode, E1 2 an encode)")
        held = hold_served_kernels(samples, label, card)
        for name in (("slice_transform", "lane_decode_round",
                      "lane_encode_rounds") if dev else ("slice_transform",)):
            check(any(re.match(rf"\(+{len(SWEEP_QS)},", s)
                      for s in held.get(name, {}).get("shapes", [])),
                  f"{label}: no {name} call at N {len(SWEEP_QS)} was held "
                  f"against its twin ({held.get(name)})")
        sweep_check(calls, paths, label)
        csvs[wire] = os.path.join(out, "rd_curve.csv")
        rows = read_csv(csvs[wire])
        check(len(rows) == len(SWEEP_QS) * len(SWEEP_BETAS) and list(rows[0])
              == ["quality", "beta", "bpp", "psnr", "ms_ssim"],
              f"{label}: rd_curve.csv has {len(rows)} rows, columns "
              f"{list(rows[0])}")
        for beta in SWEEP_BETAS:
            bpp = [float(r["bpp"]) for r in rows if float(r["beta"]) == beta]
            check(all(b >= a for a, b in zip(bpp, bpp[1:]))
                  and bpp[-1] > bpp[0],
                  f"{label}: bpp does not rise with q at beta {beta}: {bpp}")
            check(all(np.isfinite(float(r[k])) for r in rows
                      for k in ("psnr", "ms_ssim")), f"{label}: a "
                  "non-finite PSNR / MS-SSIM")
        print(f"{label}: {n} images x {len(SWEEP_QS)} qualities x "
              f"{len(SWEEP_BETAS)} betas in {secs:.1f} s (model build and "
              f"checkpoint load included; {secs / n:.2f} s an image); "
              f"launches {counts[label]}; bpp at beta 0 from "
              f"{float(rows[0]['bpp']):.4f} to {float(rows[-2]['bpp']):.4f} "
              f"[{card}]")
        del calls, samples
        torch.cuda.empty_cache()
    return csvs, counts


def metrics_phase(card: str) -> tuple:
    """Phase 19 (b): ``python -m crdr_tpu_torch.cli.calc_metrics`` on
    METRIC_IMAGES synthetic 512x768 images and the flagship's decodes of
    them, on seeded Inception / DISTS weight files in pytorch-fid's and
    DISTS' layouts and a random LPIPS; the FID of the reals against
    themselves; the card's Inception features and DISTS values against the
    same modules on the CPU.  The CLI and the self-FID (``self_fid_child``)
    run in processes of their own, their FID statistics and sqrtm on the
    host (12-27 s each in one process), beside this phase's rest and phase
    20; main waits for them with ``metrics_end``.  Returns (figures, the
    pending processes)."""
    import pickle
    import tempfile

    import torch

    from crdr_tpu_torch.cli.serve_smoke import synthetic_images
    from crdr_tpu_torch.metrics.dists import (DISTS, load_dists_params,
                                              seeded_dists_state)
    from crdr_tpu_torch.metrics.fid import (crop_hific_fid_patches,
                                            patch_features)
    from crdr_tpu_torch.metrics.inception import (f32_numerics,
                                                  load_inception,
                                                  make_inception_extractor,
                                                  seeded_inception_state)
    from crdr_tpu_torch.utils.img_utils import (read_png, tensor_to_uint8,
                                                write_png)

    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)  # removed by metrics_end
    real_dir, fake_dir = (os.path.join(tmp, d) for d in ("reals", "fakes"))
    os.makedirs(real_dir)
    os.makedirs(fake_dir)
    model = build_model(card)
    imgs = synthetic_images(METRIC_IMAGES, IMG_H, IMG_W, 23)
    bpps = []
    t0 = time.perf_counter()
    for s in range(0, METRIC_IMAGES, N_IMG):
        batch = imgs[s:s + N_IMG]
        encs = model.compress_batch(batch, rate_ind=RATE)
        fake, _, _ = model.decompress_batch([e["string_list"] for e in encs],
                                            beta=BETA)
        for j, (img, e) in enumerate(zip(batch, encs)):
            write_png(os.path.join(real_dir, f"img{s + j:02d}.png"), img)
            write_png(os.path.join(fake_dir, f"img{s + j:02d}.png"),
                      tensor_to_uint8(fake[j]))
            bpps.append(sum(len(x) for x in e["string_list"][1:]) * 8
                        / (IMG_H * IMG_W))
    with open(os.path.join(fake_dir, "_avg_bitrate.json"), "w") as f:
        json.dump({"avg_bpp": float(np.mean(bpps))}, f)
    prep_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()

    inc_state, dists_state = seeded_inception_state(0), seeded_dists_state(0)
    inc_path, dists_path = (os.path.join(tmp, f) for f in
                            ("inception.pkl", "dists.pkl"))
    for path, state in ((inc_path, inc_state), (dists_path, dists_state)):
        with open(path, "wb") as f:
            pickle.dump(state, f)
    env = dict(os.environ, CRDR_INCEPTION_WEIGHTS=inc_path,
               CRDR_DISTS_WEIGHTS=dists_path, CRDR_ALLOW_RANDOM_LPIPS="1")
    env.pop("CRDR_LPIPS_WEIGHTS", None)
    cli = start_proc([sys.executable, "-m", "crdr_tpu_torch.cli.calc_metrics",
                      "--real_dir", real_dir, "--fake_dir", fake_dir, "-d",
                      CARD, "--metrics", "psnr", "ms_ssim", "lpips", "fid",
                      "dists"], ROOT, os.path.join(tmp, "calc_metrics.log"),
                     env)

    # the FID of the reals against themselves; the card against the CPU
    reals = [read_png(os.path.join(real_dir, f"img{i:02d}.png"))
             for i in range(METRIC_IMAGES)]
    extract = make_inception_extractor(inc_path, CARD)
    t0 = time.perf_counter()
    feats = patch_features(reals, extract)
    feat_s = time.perf_counter() - t0
    fpath = os.path.join(tmp, "feats.npy")
    np.save(fpath, feats)
    self_fid = start_proc([sys.executable, "-c", "import sys, chip_smoke; "
                           "chip_smoke.self_fid_child(sys.argv[1])", fpath],
                          ROOT, fpath + ".log")
    patches = crop_hific_fid_patches(reals[0])[:4]
    cpu_inc = load_inception(inc_state, "cpu")
    with torch.no_grad():
        ref = cpu_inc(torch.from_numpy(patches).permute(0, 3, 1, 2).float())
    ref = ref.numpy()
    inc_err = float(np.abs(extract(patches) - ref).max()
                    / np.abs(ref).max())
    check(inc_err <= INCEPTION_REL, f"Inception features card vs CPU: "
          f"{inc_err:.3e} of the largest (<= {INCEPTION_REL})")
    crop = (slice(128, 384), slice(256, 512))
    a = torch.from_numpy(reals[0][crop]).permute(2, 0, 1)[None].float() / 255
    b = torch.from_numpy(read_png(os.path.join(fake_dir, "img00.png"))[crop])
    b = b.permute(2, 0, 1)[None].float() / 255
    vals = {}
    for dev in ("cpu", CARD):
        mod = DISTS()
        mod.load_state_dict(load_dists_params(dists_state))
        mod = mod.to(dev).eval()
        with f32_numerics():
            vals[dev] = float(mod(a.to(dev), b.to(dev))[0])
    dists_err = abs(vals[CARD] - vals["cpu"])
    check(dists_err <= DISTS_ATOL, f"DISTS card {vals[CARD]} vs CPU "
          f"{vals['cpu']} (|diff| <= {DISTS_ATOL})")
    print(f"Inception pool3 card vs CPU on {len(patches)} patches: max "
          f"|diff| {inc_err:.3e} of the largest feature; DISTS on a 256x256 "
          f"pair card {vals[CARD]:.6f} vs CPU {vals['cpu']:.6f} (|diff| "
          f"{dists_err:.2e}) [{card}]")
    return ({"inception_rel_err": inc_err, "dists_abs_err": dists_err,
             "prep_s": prep_s},
            {"tmp": tmp, "fake_dir": fake_dir, "cli": cli,
             "self_fid": self_fid, "feats": fpath, "n": len(feats),
             "feat_s": feat_s})


def self_fid_child(path: str) -> None:
    """The FID of the features in ``path`` (.npy) against themselves and
    2 tr(sigma), written as JSON beside them (``metrics_phase``)."""
    sys.path.insert(0, ROOT)
    from crdr_tpu_torch.metrics.fid import activation_statistics, compute_fid

    feats = np.load(path)
    t0 = time.perf_counter()
    fid = compute_fid(feats, feats)
    fid_s = time.perf_counter() - t0
    terms = 2 * float(np.trace(activation_statistics(feats)[1]))
    with open(path + ".json", "w") as f:
        json.dump({"self_fid": fid, "self_fid_terms": terms,
                   "self_fid_s": fid_s}, f)


def metrics_end(pending: dict, card: str) -> dict:
    """Waits for ``metrics_phase``'s processes: the CLI's ``_metrics.json``
    has the JAX script's keys, finite values and LPIPS tagged random; the
    FID of the reals against themselves is within SELF_FID_REL of
    2 tr(sigma).  Returns the figures."""
    cli = pending["cli"]
    rc, log, cli_s = end_proc(cli)
    check(rc == 0, f"calc_metrics exited {rc}:\n{log[-6000:]}")
    with open(os.path.join(pending["fake_dir"], "_metrics.json")) as f:
        res = json.load(f)
    keys = {"PSNR", "MS-SSIM", "LPIPS", "LPIPS_weights", "FID", "DISTS",
            "bpp"}
    check(set(res) == keys, f"calc_metrics keys {sorted(res)} (expected the "
          f"JAX script's {sorted(keys)})")
    check(res["LPIPS_weights"] == "random", "LPIPS on a random init must be "
          f"tagged 'random', got {res['LPIPS_weights']!r}")
    check(all(np.isfinite(res[k]) for k in keys - {"LPIPS_weights"}),
          f"calc_metrics: a non-finite value {res}")
    print(f"calc_metrics on {METRIC_IMAGES} pairs (seeded Inception / DISTS "
          f"weights, random LPIPS: not the metrics' values): {res}; "
          f"{cli_s:.1f} s from its process's start to its exit (beside the "
          f"rest of phase 19 and phase 20) [{card}]")
    rc, log, _ = end_proc(pending["self_fid"])
    check(rc == 0, f"the self-FID process exited {rc}:\n{log[-3000:]}")
    with open(pending["feats"] + ".json") as f:
        fid = json.load(f)
    shutil.rmtree(pending["tmp"], ignore_errors=True)
    terms = fid["self_fid_terms"]
    check(abs(fid["self_fid"]) <= SELF_FID_REL * terms, f"FID of the reals "
          f"against themselves {fid['self_fid']} (|.| <= {SELF_FID_REL} x "
          f"2 tr(sigma) = {SELF_FID_REL * terms:.3e} expected)")
    print(f"FID of the reals against themselves {fid['self_fid']:.3e}, "
          f"{abs(fid['self_fid']) / terms:.2e} of 2 tr(sigma) "
          f"({pending['n']} patches; features {pending['feat_s']:.2f} s on "
          f"the card, statistics and sqrtm {fid['self_fid_s']:.1f} s on the "
          f"host, in a process of its own) [{card}]")
    return {**res, **fid, "seconds": cli_s}


def bd_phase(csvs: dict, card: str) -> dict:
    """Phase 19 (c): ``python -m crdr_tpu_torch.cli.bd_rate`` (its ``main``)
    with the compressai wire's sweep as the anchor and the device wire's as
    the test.  y_hat is equal on the two wires, so is PSNR: the BD-rate is
    an average of the per-quality rate gaps, and lies within their range."""
    from crdr_tpu_torch.cli import bd_rate

    res = {}
    rows = {w: read_csv(p) for w, p in csvs.items()}
    for beta in SWEEP_BETAS:
        out = bd_rate.main([csvs["compressai"], csvs["device"], "--beta",
                            str(beta)])
        a, t = ([r for r in rows[w] if float(r["beta"]) == beta]
                for w in ("compressai", "device"))
        check([r["psnr"] for r in a] == [r["psnr"] for r in t],
              f"beta {beta}: PSNR differs between the wires")
        gaps = [(float(y["bpp"]) / float(x["bpp"]) - 1) * 100
                for x, y in zip(a, t)]
        mean = (np.exp(np.mean([np.log(1 + g / 100) for g in gaps])) - 1) * 100
        check(min(gaps) - 0.05 <= out["bd_rate_pct"] <= max(gaps) + 0.05,
              f"beta {beta}: BD-rate {out['bd_rate_pct']} % outside the "
              f"per-quality gaps [{min(gaps):.3f}, {max(gaps):.3f}] %")
        print(f"BD-rate, device wire against compressai wire, beta {beta}: "
              f"{out['bd_rate_pct']:+.3f} % (mean log-rate gap "
              f"{mean:+.3f} %, per-quality gaps {min(gaps):+.3f} .. "
              f"{max(gaps):+.3f} %; BD-PSNR {out['bd_quality']}) [{card}]")
        res[str(beta)] = {"bd_rate_pct": out["bd_rate_pct"],
                          "mean_gap_pct": float(mean)}
    return res


def eval_phase(card: str):
    """Phase 19: the sweep, the metrics, BD-rate.  Returns (figures,
    {path: launches}, the processes ``metrics_end`` waits for)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        csvs, counts = sweep_phase(card, tmp)
        metrics, pending = metrics_phase(card)
        bd = bd_phase(csvs, card)
    res = {"metrics": metrics, "bd": bd,
           "phase_s": time.perf_counter() - t0}
    print(f"evaluation phase: {res['phase_s']:.1f} s, calc_metrics and the "
          f"self-FID running on [{card}]")
    return res, counts, pending


# ---------------- phase 20: Cheng20 and HiFiC on the card --------------------

FAMILIES = ("cheng20", "cheng20_interp_ca", "hific")
# no warm-up, timed or padding round trips: a Cheng20 batch direction
# takes 1-2 s (PERF.md §5: ~124k launches of cuDNN's FFT-tiling GEMM), so
# each wire's times are its counted round trip's, cold
FAMILY_RUNS = 0


def family_config(family: str, tiny: bool = False) -> dict:
    """An in-memory model config of the Cheng20 / Cheng20-InterpCA / HiFiC
    families (no file in config/ builds them): config/balle18_mean_scale
    .yaml with the family's subnets.  Cheng20: N 192, y 192, the Cheng20
    hyper pair to 384 (CompressAI's cheng2020-attn, qualities 4-6);
    InterpCA: rate_level 5; HiFiC: y 220, filters 60-960, the Balle18
    hyper pair 220 -> 192 / 440.  ``tiny``: y 32, z 16, main 16 (HiFiC
    filters 8-32, 2 residual blocks), for a CPU rehearsal."""
    from crdr_tpu_torch.utils.config import Config

    opt = Config.from_file(os.path.join(
        ROOT, "config", "balle18_mean_scale.yaml")).to_dict()
    y, z, m = (32, 16, 16) if tiny else (192, 192, 192)
    if family == "hific":
        y = 32 if tiny else 220
        f = [8, 8, 16, 16, 32] if tiny else [60, 120, 240, 480, 960]
        enc = {"type": "HificEncoder", "bottleneck_y": y, "filters": f}
        dec = {"type": "HificDecoder", "bottleneck_y": y, "filters": f[::-1],
               "n_residual_blocks": 2 if tiny else 9}
        hyper = "Balle18"
    else:
        cls = "Cheng20InterpCa" if family == "cheng20_interp_ca" \
            else "Cheng20"
        enc = {"type": f"{cls}Encoder", "in_ch": 3, "out_ch": y,
               "main_ch": m}
        dec = {"type": f"{cls}Decoder", "in_ch": y, "out_ch": 3,
               "main_ch": m}
        if family == "cheng20_interp_ca":
            ca = {"actv": "softplus", "use_interp": True, "use_bias": True}
            for d in (enc, dec):
                d.update(rate_level=5, ca_kwargs=dict(ca))
        hyper = "Cheng20"
    opt["subnet"] = {
        "encoder": enc, "decoder": dec,
        "hyperencoder": {"type": f"{hyper}HyperEncoder", "in_ch": y,
                         "out_ch": z, "main_ch": m},
        "hyperdecoder": {"type": f"{hyper}HyperDecoder", "in_ch": z,
                         "out_ch": 2 * y, "main_ch": m},
        "entropy_model_z": {"type": "SteEntropyBottleneck", "channels": z},
        "entropy_model_y": {"type": "SteGaussianMeanScaleConditional",
                            "scale_bound": 0.11}}
    opt["model_type"] = "InterpCaHyperpriorModel" \
        if family == "cheng20_interp_ca" else "HyperpriorModel"
    return opt


def build_family_model(family: str, imgs, card: str,
                       instance_norm: bool = False, **opts):
    """The family's model: seeded init, every GDN's gamma re-drawn
    non-symmetric, y spread over ~Y_STD bins by a gain on the last analysis
    conv, the hyper-decoder's scale half raised (as phase 7).
    ``instance_norm``: HiFiC with ``channel_norm: False`` in the encoder
    and the decoder; ``opts`` go into the options."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.nn import GDN, NonNegativeParam
    from crdr_tpu_torch.utils.config import ConfigDict

    t0 = time.perf_counter()
    cfg = dict(family_config(family), **opts)
    if instance_norm:
        for part in ("encoder", "decoder"):
            cfg["subnet"][part]["channel_norm"] = False
    model = build_comp_model(ConfigDict(cfg), device=CARD)
    net = model.net
    g = torch.Generator(device=model.device).manual_seed(4321)
    last_conv = net.encoder.conv_block_out if family == "hific" \
        else net.encoder.conv7
    last_hyper = net.hyperdecoder.c3 if family == "hific" \
        else net.hyperdecoder.c5
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, GDN):
                c = m.gamma.shape[0]
                m.gamma.copy_(NonNegativeParam().init(torch.empty_like(
                    m.gamma).uniform_(0.0, 2.0 / c, generator=g)))
        x = torch.from_numpy(imgs[:1]).to(model.device)
        x = ((x.float() / 255.0 - 0.5) * 2.0).permute(0, 3, 1, 2)
        ri = torch.full((1,), RATE, device=model.device)
        y = net.encode(x.contiguous(), ri)
        gain = Y_STD / float(y.std())
        last_conv.weight.mul_(gain)
        last_conv.bias.mul_(gain)
        half = last_hyper.bias.numel() // 2
        last_hyper.bias[half:] += Y_STD
    model.codec_setup()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    nparam = sum(p.numel() for p in net.parameters())
    print(f"{family} {model.opt.model_type} ({type(net.encoder).__name__}): "
          f"{nparam / 1e6:.1f}M params, analysis gain {gain:.2f}, built in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return model


def family_phase(imgs, card: str, profiling: bool = False):
    """Phase 20: each family on both wires (the generic device wire, E1),
    the checks of phases 3 and 4, K3 6 a round trip on Cheng20 (every K3
    call held against gdn_plain), 0 on HiFiC; then Cheng20 at
    transform_dtype bfloat16, one round trip on the device wire (6 bf16 K3
    launches).  Returns ({path: launches}, {path: times})."""
    import torch

    counts, times = {}, {}
    for family in FAMILIES:
        model = build_family_model(family, imgs, card)
        gdn = 0 if family == "hific" else 6
        label = f"{family} compressai"
        with sampled_kernel_calls() as samples:
            encs, counts[label], times[label] = host_wire_path(
                model, imgs, label, {"slice_transform": 0,
                                     "lane_decode_round": 0, "gdn": gdn},
                card, runs=FAMILY_RUNS, padding=False)
        if gdn:  # batch 4; batch 1 too from the padding measurement
            held = hold_served_kernels(samples, label, card)
            at4 = [s for s in held["gdn"]["shapes"]
                   if s.startswith(f"(({N_IMG},")]
            check(len(at4) == 6, f"{label}: K3 held at {at4} at batch "
                  f"{N_IMG} (3 shapes x 2 directions expected)")
        del samples
        y_c = np.concatenate([e["y_hat"] for e in encs])
        label = f"{family} device wire"
        _, counts[label], times[label], _ = device_wire_path(
            model, imgs, y_c, card, label, encoder="device", gdn=gdn,
            runs=FAMILY_RUNS)
        if profiling:
            encs = model.compress_batch(imgs, rate_ind=RATE)
            profile_phase(lambda: model.compress_batch(imgs, rate_ind=RATE),
                          f"{family} device-wire encode batch {N_IMG}", card,
                          ("gdn_kernel", "lane_encode"))
            profile_phase(lambda: model.decompress_batch(
                [e["string_list"] for e in encs], beta=BETA),
                f"{family} device-wire decode batch {N_IMG}", card,
                ("gdn_kernel", "lane_decode"))
        if family == "cheng20":  # one round trip at bf16, this wire
            label = f"{family} bf16 device wire"
            res = bf16_round_trip(model, imgs, label,
                                  device_wire_expected(model, "device", 6),
                                  card)
            counts[label] = res["launches"]
            times[label] = {k: res[k] for k in ("encode_ms", "decode_ms",
                                                "psnr")}
        del model, encs
        torch.cuda.empty_cache()
    return counts, times


# ---------------- phase 21: the train transform's resize_range --------------

RESIZE_STEPS = 5
STAGE1_STEP_MS = 125.0   # stage 1's step on the H100 (PERF.md §6)


class TimedLoader:
    """A data loader whose consumer's wait for each batch is timed."""

    def __init__(self, loader):
        self.loader, self.waits = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append((time.perf_counter() - t0) * 1e3)
            yield batch


def resize_phase(card: str) -> dict:
    """Phase 21: endurance_r4_stage1.yaml's recipe as written (resize_range
    [0.5, 1.0], bicubic, uint8 samples) on synthetic 512x768 PNG sources in
    a temporary directory.  5 steps through train_loop; the resampler's ms
    per sample at 768x512 and 1024x768, bicubic (the recipe's) beside
    bilinear; the loader's wait per step."""
    import tempfile

    import torch

    from crdr_tpu_torch.cli.serve_smoke import synthetic_images
    from crdr_tpu_torch.data import build_dataset
    from crdr_tpu_torch.data.resize import resize
    from crdr_tpu_torch.trainer import build_trainer
    from crdr_tpu_torch.utils.img_utils import write_png

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "sources")
        os.makedirs(src)
        for i, img in enumerate(synthetic_images(16, IMG_H, IMG_W, 29)):
            write_png(os.path.join(src, f"src{i:02d}.png"), img)
        cfg = train_config("endurance_r4_stage1.yaml", tmp, "r4",
                           total_iter=RESIZE_STEPS, log_step=RESIZE_STEPS)
        check(cfg.dataset.train_dataset.get("interpolation",
                                            "bicubic") == "bicubic",
              "endurance_r4_stage1.yaml is no longer bicubic")
        cfg.dataset.train_dataset.update(root_dir=src)
        cfg.dataset.eval_dataset.update(root_dir=src)

        # the resampler alone, at the scales the transform draws
        for interp in ("bicubic", "bilinear"):
            rng = np.random.default_rng(0)
            for h, w in ((512, 768), (768, 1024)):
                img = synthetic_images(1, h, w, 31)[0]
                runs = []
                for _ in range(12):
                    s = rng.uniform(0.5, 1.0)
                    t0 = time.perf_counter()
                    resize(img, (int(w * s), int(h * s)), interp)
                    runs.append((time.perf_counter() - t0) * 1e3)
                res[f"{interp}_ms_{w}x{h}"] = float(np.median(runs[2:]))
        ds = build_dataset(cfg.dataset.train_dataset, is_train=True)
        runs = []
        for i in range(12):
            t0 = time.perf_counter()
            ds[i]
            runs.append((time.perf_counter() - t0) * 1e3)
        res["sample_ms_768x512"] = float(np.median(runs[2:]))

        tr = build_trainer(cfg, CARD)
        check(tr.train_loader.dataset.resize_range is not None,
              "the trainer's dataset has no resize_range")
        loader = TimedLoader(tr.train_loader)
        tr.train_loader = loader
        logs, steps, _ = record_steps(tr)
        t0 = time.perf_counter()
        tr.train_loop()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(len(logs) == RESIZE_STEPS, f"resize_range run: {len(logs)} "
              f"steps ({RESIZE_STEPS} expected)")
        last = check_logs(logs, "resize_range run")
        batch = next(iter(tr.train_loader.loader))["real_images"]
        check(batch.dtype == np.uint8 and batch.shape == (8, 256, 256, 3),
              f"resize_range batch {batch.dtype} {batch.shape}")
        waits = loader.waits[1:]  # the first includes the loader's start
        res.update(steps=len(logs), step_ms=float(np.median(steps[1:])),
                   wait_ms=float(np.mean(waits)),
                   wait_max_ms=float(np.max(waits)),
                   first_wait_ms=loader.waits[0], run_s=secs,
                   loss_last=last["total"])
        del tr
        torch.cuda.empty_cache()
    print(f"resize_range (the recipe's bicubic, uint8): resampler "
          f"{res['bicubic_ms_768x512']:.2f} ms a sample at 768x512, "
          f"{res['bicubic_ms_1024x768']:.2f} ms at 1024x768 (bilinear "
          f"{res['bilinear_ms_768x512']:.2f} / "
          f"{res['bilinear_ms_1024x768']:.2f} ms); a whole train "
          f"transform {res['sample_ms_768x512']:.2f} ms at 768x512 (PNG read "
          f"included); {res['steps']} steps of endurance_r4_stage1.yaml, "
          f"median step {res['step_ms']:.1f} ms, the loader's wait "
          f"{res['wait_ms']:.2f} ms a step (max {res['wait_max_ms']:.2f}; "
          f"first {res['first_wait_ms']:.1f}) against the "
          f"{STAGE1_STEP_MS:.0f} ms stage-1 step; last total loss "
          f"{res['loss_last']:.4f} [{card}]")
    return res


# ---------------- phase 22: data parallel on the card -------------------------

def card_device():
    """The one card as a device of a mesh (``CARD``: the CPU in a
    rehearsal)."""
    import torch

    return torch.device("cuda", 0) if CARD == "cuda" else torch.device(CARD)


DP_STEPS = 4          # compared steps; the 2-rank run takes one more after
#                       its checkpoint
DP_RTOL, DP_ATOL, DP_LOSS = 2e-3, 2e-5, 2e-3   # tests/test_trainer_dp.py
# Gradients that agree to this fraction every step move Adam's update by
# about twice it a step (its m / sqrt(v) is homogeneous in g), so over 4
# steps at lr 1e-4 a parameter by <= 8 x 0.01 x 1e-4 = 8e-6 < DP_ATOL:
# the parameters are held to JAX's tolerance wherever the two runs'
# gradients agree to it
DP_GRAD_APART = 0.01
DP_LABELS = ("stage1", "gdn")


def dp_config(label: str, tmp: str, exp: str, **over):
    """Phase 22's configs: endurance_stage1.yaml at full width, batch 8,
    256x256, f32 (mixed_precision off); ``gdn``: its recipe on the Balle18
    GDN model (phase 15's)."""
    from crdr_tpu_torch.utils.config import Config

    cfg = train_config("endurance_stage1.yaml", tmp, exp,
                       total_iter=DP_STEPS + 1, mixed_precision=False,
                       num_workers=2, **over)
    if label == "gdn":
        bal = Config.from_file(os.path.join(ROOT, "config",
                                            "balle18_mean_scale.yaml"))
        cfg["model_type"], cfg["subnet"] = bal.model_type, bal.subnet
    return cfg


def dp_steps(tr, steps: int, out: dict, tag: str,
             keep_grads: bool = False) -> None:
    """``steps`` steps on the trainer's loader, each timed between two
    synchronizes: its rows of each batch, the logs, step 1's averaged main
    gradient (with ``keep_grads``, every step's: "grads") and the
    parameters after the last step (the flat buffers), and K3's
    launches."""
    import hashlib

    import torch

    from crdr_tpu_torch.data import cycle
    from crdr_tpu_torch.ops.gdn import gdn

    rows, logs, ms, grads = [], [], [], []
    gdn.launches = 0
    for itr, data in cycle(tr.train_loader, tr.step, tr.step + steps):
        rows.append(np.asarray(data["real_images"]).copy())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs.append(tr.optimize_parameters(itr, data))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if itr == 1 or keep_grads:
            grads.append(tr.g_opt.flat_grad.cpu().numpy().copy())
    flat = tr.g_opt.flat.cpu().numpy()
    out.update({f"{tag}rows": rows, f"{tag}logs": logs, f"{tag}ms": ms,
                f"{tag}k3": gdn.launches,
                f"{tag}digest": hashlib.sha256(flat.tobytes()).hexdigest(),
                f"{tag}flat": flat.copy()})
    if grads:
        out[f"{tag}grad1"] = grads[0]
    if keep_grads:
        out[f"{tag}grads"] = grads


def dp_rank(rank: int, world: int, device, tmp: str, card: str) -> dict:
    """One rank of phase 22 (a spawned process on the card, over gloo):
    each model DP_STEPS steps, the GDN model's K3 calls sampled and each
    held against gdn_plain here (a failure fails the rank); stage 1 then
    saves (rank 0 writes) and takes one more step.  Rank 0's arrays (every
    step's averaged gradient, the parameters) go to .npy files under
    ``tmp``; every rank returns its digests, rows, logs, times, K3 launches
    and the K3 shapes held."""
    import torch

    from crdr_tpu_torch.trainer import build_trainer

    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for label in DP_LABELS:
        tr = build_trainer(dp_config(label, tmp, f"dp2_{label}",
                                     n_devices=world), device)
        out = {}
        with sampled_kernel_calls() as samples:
            dp_steps(tr, DP_STEPS, out, "", keep_grads=rank == 0)
        out["held"] = hold_served_kernels(
            samples, f"DP {label} rank {rank}", card)
        del samples
        if label == "stage1":
            tr.save(tr.step)
            dp_steps(tr, 1, out, "next_")
        for key in [k for k in out if k.endswith(("grad1", "flat"))]:
            arr = out.pop(key)
            if rank == 0:
                path = os.path.join(tmp, f"rank0_{label}_{key}.npy")
                np.save(path, arr)
                out[key] = path
        if rank == 0:
            grads = out.pop("grads")
            out["grads"] = []
            for s, g in enumerate(grads):
                path = os.path.join(tmp, f"rank0_{label}_grad_step{s + 1}.npy")
                np.save(path, g)
                out["grads"].append(path)
            del grads
        res[label] = out
        del tr
        torch.cuda.empty_cache()
    return res


def dp_blocks_step(tr, shards, itr: int) -> None:
    """One step of the one-process trainer ``tr`` on the ranks' ``shards``
    taken as the ranks take them: the trainer's own step at
    ``micro_batches`` = the shard count (rd_trainer.py's module doc)."""
    tr.micro_batches = len(shards)
    tr.optimize_parameters(itr, {"real_images": np.concatenate(shards)})


def flat_digest(tr) -> str:
    import hashlib

    return hashlib.sha256(tr.g_opt.flat.cpu().numpy().tobytes()).hexdigest()


def per_param_rel(tr, a: np.ndarray, b: np.ndarray) -> dict:
    """Relative L2 of a against b, per parameter of ``tr.g_opt``'s flat
    layout: {name: rel}."""
    out = {}
    for name, off, size in zip(tr.g_opt.names, tr.g_opt.offsets,
                               tr.g_opt.sizes):
        x, y = a[off:off + size].astype(np.float64), b[off:off + size]
        out[name] = float(np.linalg.norm(x - y) / max(np.linalg.norm(y),
                                                      1e-30))
    return out


def dp_rounding(opt, rank_grads, one_grads) -> tuple:
    """Where the two runs' averaged gradients (``rank_grads``: the ranks',
    .npy paths; ``one_grads``: batch 8's) part on some step, over ``opt``'s
    flat buffer: (sign, where |g2 - g8| >= |g8| > 0 or g8 = 0 < |g2|: batch
    8's gradient no farther from 0 than the two sums are apart, its sign
    rounding; apart, where |g2 - g8| > DP_GRAD_APART |g8|; the mask of the
    parameters' own elements, not the buffer's padding)."""
    sign = np.zeros(opt.flat.numel(), bool)
    apart = np.zeros_like(sign)
    for path, g8 in zip(rank_grads, one_grads):
        diff = np.abs(np.load(path).astype(np.float64) - g8)
        sign |= (diff > 0) & (diff >= np.abs(g8))
        apart |= diff > DP_GRAD_APART * np.abs(g8)
        del diff
    own = np.zeros_like(sign)
    for off, size in zip(opt.offsets, opt.sizes):
        own[off:off + size] = True
    return sign, apart, own


def dp_close(a: np.ndarray, b: np.ndarray, masks) -> dict:
    """|a - b| / (atol + rtol |b|) per element (<= 1 passes): its worst,
    the count past it, of those how many ``dp_rounding``'s masks cover,
    and the worst and the count past it among the elements whose gradients
    never part by DP_GRAD_APART."""
    sign, apart, own = masks
    excess = np.abs(a.astype(np.float64) - b) / (DP_ATOL + DP_RTOL * np.abs(b))
    past = (excess > 1) & own
    rest = excess[own & ~apart]
    return {"worst": float(excess.max()), "past": int(past.sum()),
            "past_sign_rounding": int((past & sign).sum()),
            "past_apart": int((past & apart).sum()),
            "sign_rounding": int((sign & own).sum()),
            "apart": int((apart & own).sum()),
            "worst_rest": float(rest.max()) if rest.size else 0.0,
            "past_rest": int((rest > 1).sum())}


def dp_phase(card: str) -> tuple:
    """Phase 22: data parallel on the card (module doc)."""
    import tempfile

    import torch

    from crdr_tpu_torch.parallel import spawn
    from crdr_tpu_torch.trainer import build_trainer

    t_phase = time.perf_counter()
    res, counts = {}, {}
    saved_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    dev = card_device()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn(dp_rank, 2, backend="gloo", devices=[dev, dev],
                      args=(tmp, card))
        res["ranks_s"] = time.perf_counter() - t0
        for label in DP_LABELS:
            r0, r1 = (r[label] for r in ranks)
            check(r0["digest"] == r1["digest"],
                  f"DP {label}: the two ranks' parameters differ")
            check(r0["logs"] == r1["logs"], f"DP {label}: rank logs differ")
            # the ranks' arithmetic in one process, with no group
            acc = build_trainer(dp_config(label, tmp, f"acc_{label}"))
            for s in range(DP_STEPS):
                dp_blocks_step(acc, [r0["rows"][s], r1["rows"][s]], s + 1)
                if s == 0:
                    acc_g1 = acc.g_opt.flat_grad.cpu().numpy().copy()
            exact = flat_digest(acc) == r0["digest"] and np.array_equal(
                acc_g1, np.load(r0["grad1"]))
            print(f"DP {label}: the 2 ranks' parameters after {DP_STEPS} "
                  f"steps and step 1's averaged gradient bit-equal to one "
                  f"process taking the same 2 shards a step with no group "
                  f"(its step at micro_batches 2): "
                  f"{exact}")
            check(exact, f"DP {label}: the ranks differ from the same "
                  "arithmetic in one process")
            del acc
            # one process at batch 8 (cuDNN sums a batch of 8 otherwise)
            tr = build_trainer(dp_config(label, tmp, f"one_{label}"))
            one = {}
            dp_steps(tr, DP_STEPS, one, "", keep_grads=True)
            for s in range(DP_STEPS):
                check(np.array_equal(np.concatenate(
                    [r0["rows"][s], r1["rows"][s]]), one["rows"][s]),
                    f"DP {label}: the ranks' rows of step {s + 1} are not "
                    "the one process's batch")
            loss_d = max(abs(a[k] - b[k]) for a, b in zip(one["logs"],
                                                           r0["logs"])
                         for k in ("total", "rate", "distortion", "bpp"))
            rel = per_param_rel(tr, np.load(r0["grad1"]), one["grad1"])
            worst_g = max(rel, key=rel.get)
            close = dp_close(np.load(r0["flat"]), one["flat"], dp_rounding(
                tr.g_opt, r0["grads"], one.pop("grads")))
            k3 = [r0["k3"], r1["k3"]]
            row = {"bit_equal_to_shards_in_one_process": exact,
                   "loss_max_abs_diff": loss_d,
                   "grad1_rel_l2_max": rel[worst_g], "grad1_worst": worst_g,
                   "grad1_rel_l2_median": float(np.median(list(
                       rel.values()))),
                   "params_worst_ratio": close["worst"],
                   "params_past_tol": close["past"],
                   **{f"params_{k}": v for k, v in close.items()
                      if k not in ("worst", "past")},
                   "params": int(sum(tr.g_opt.sizes)),
                   "rank_ms_per_step": [float(np.median(r0["ms"][1:])),
                                        float(np.median(r1["ms"][1:]))],
                   "one_ms_per_step": float(np.median(one["ms"][1:])),
                   "k3_per_rank": k3,
                   "k3_held_per_rank": [r0["held"].get("gdn"),
                                        r1["held"].get("gdn")]}
            print(f"DP {label}: 2 ranks (gloo, both on {card}, 4 images "
                  f"each) vs one process at batch 8, {DP_STEPS} steps, f32: "
                  f"losses within {loss_d:.2e}, step 1's averaged gradient "
                  f"relative L2 per parameter max {rel[worst_g]:.2e} "
                  f"({worst_g}), median {row['grad1_rel_l2_median']:.2e}; "
                  f"parameters after step {DP_STEPS}: worst |diff| / (atol "
                  f"+ rtol |p|) {close['worst']:.3f}, {close['past']} of "
                  f"{row['params']} past rtol {DP_RTOL} / atol {DP_ATOL}, "
                  f"of them {close['past_apart']} where on some step the "
                  f"two runs' averaged gradients part by more than "
                  f"{DP_GRAD_APART:.0%} ({close['apart']} such elements in "
                  f"all), {close['past_sign_rounding']} of those where batch "
                  f"8's is no farther from 0 than the two are apart (its "
                  f"sign rounding; {close['sign_rounding']} in all); the "
                  f"{row['params'] - close['apart']} others: worst "
                  f"{close['worst_rest']:.3f}, {close['past_rest']} past; "
                  f"ms a step per rank "
                  f"{[round(v, 1) for v in row['rank_ms_per_step']]} (the "
                  f"two ranks share one card and all-reduce over gloo: not "
                  f"a scaling figure), one process "
                  f"{row['one_ms_per_step']:.1f}; K3 per rank {k3}")
            check(loss_d < DP_LOSS, f"DP {label}: losses apart by {loss_d}")
            check(close["past_rest"] == 0, f"DP {label}: {close['past_rest']}"
                  f" parameters past rtol {DP_RTOL} / atol {DP_ATOL} whose "
                  f"gradients agree to {DP_GRAD_APART} every step")
            for r, rk in enumerate((r0, r1)):
                check(len(rk["held"].get("gdn", {}).get("shapes", [])) ==
                      (6 if label == "gdn" else 0), f"DP {label} rank {r}: "
                      f"K3 held at {rk['held']} (6 shapes expected)")
            check(rel[worst_g] <= GRAD_REL, f"DP {label}: step 1's gradient "
                  f"of {worst_g} {rel[worst_g]:.2e} from batch 8's")
            want_k3 = 6 * (DP_STEPS if label == "gdn" else 0)
            check(k3 == [want_k3] * 2 and one["k3"] == want_k3,
                  f"DP {label}: K3 launched {k3} / {one['k3']} times "
                  f"({want_k3} expected a rank)")
            counts[f"dp {label} rank 0"] = {"gdn": r0["k3"]}
            counts[f"dp {label} rank 1"] = {"gdn": r1["k3"]}
            res[label] = row
            del tr
            torch.cuda.empty_cache()
            if label == "stage1":
                res["nccl_world1"] = dp_nccl_world1(label, tmp, card)
                # the 2-rank checkpoint resumes in one process
                rs = build_trainer(dp_config(label, tmp, "dp2_stage1",
                                             start_iter=DP_STEPS))
                dp_blocks_step(rs, [r0["next_rows"][0], r1["next_rows"][0]],
                               DP_STEPS + 1)
                same = rs.world == 1 and flat_digest(rs) == \
                    r0["next_digest"]
                print(f"DP resume: the 2 ranks' step-{DP_STEPS} checkpoint "
                      f"in one process; its step {DP_STEPS + 1} on the "
                      f"ranks' shards bit-equal to the ranks': {same}")
                check(same, "DP resume: one process did not follow the "
                      "ranks")
                res["resume_bit_equal"] = same
                del rs
                torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = saved_tf32
    gc.collect()  # the trainers' reference cycles hold their buffers
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"data-parallel phase: {res['phase_s']:.1f} s (ranks "
          f"{res['ranks_s']:.1f} s) [{card}]")
    return res, counts


def dp_nccl_world1(label: str, tmp: str, card: str) -> dict:
    """One step of a trainer in a group of one rank over NCCL (its
    collectives run) against the same step alone: bit-equal."""
    import torch
    import torch.distributed as tdist

    from crdr_tpu_torch.parallel.distributed import free_port
    from crdr_tpu_torch.trainer import build_trainer

    alone = build_trainer(dp_config(label, tmp, "alone"))
    data = next(iter(alone.train_loader))
    a = alone.optimize_parameters(1, data)
    flat_a = alone.g_opt.flat.clone()
    del alone
    backend = "nccl" if CARD == "cuda" else "gloo"
    tdist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                             f"{free_port()}", world_size=1, rank=0)
    try:
        tr = build_trainer(dp_config(label, tmp, "nccl1", n_devices=1))
        check(tr.dp and tr.world == 1, "NCCL world 1: no group")
        b = tr.optimize_parameters(1, data)
        torch.cuda.synchronize()
        equal = bool(torch.equal(tr.g_opt.flat, flat_a)) and a == b
    finally:
        tdist.destroy_process_group()
    print(f"DP over {backend} at world size 1: one step, parameters and "
          f"logs bit-equal to the step alone: {equal} [{card}]")
    check(equal, "NCCL world 1: the step differs from the step alone")
    return {"bit_equal": equal}


# ---------------- phase 23: the serving mesh on the card ------------------------

SPATIAL_H, SPATIAL_W = 2048, 3072


def mesh_model(card: str, mesh, **opts):
    """build_model's flagship with ``opts`` in its options and the serving
    mesh on ``mesh``."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import Config

    cfg = Config.from_file(os.path.join(ROOT, "config",
                                        "crdr_throughput.yaml"))
    cfg.update(opts)
    model = build_comp_model(cfg)
    raise_y_scales(model)
    model.codec_setup(mesh)
    torch.cuda.synchronize()
    return model


def mesh_phase(imgs, card: str) -> tuple:
    """Phase 23: the serving mesh on the card (module doc)."""
    import torch

    t_phase = time.perf_counter()
    mesh = [card_device()] * 2
    kernels = kernel_wrappers()
    res, counts = {}, {}
    one = build_model(card)
    two = mesh_model(card, mesh, serving_devices=2)
    check(len(two._replicas) == 2 and two._replicas[1].net is not one.net,
          "batch mesh: no second replica")
    per_dispatch = {"compressai": {"slice_transform": 6 * one.num_slices,
                                   "lane_decode_round": 0,
                                   "lane_encode_rounds": 0, "gdn": 0},
                    "device": {"slice_transform": 6 * one.num_slices,
                               "lane_decode_round": 1 + one.num_slices,
                               "lane_encode_rounds": 2, "gdn": 0}}
    for wire, want in per_dispatch.items():
        for m in (one, two):
            m.opt["wire_format"] = wire
            m.opt["device_wire_encoder"] = "device"
            m.codec_setup()
        round_trip(one, imgs)  # warm: this wire's first call
        enc1, (f1, _, y1), _, _ = round_trip(one, imgs)
        with sampled_kernel_calls() as samples:
            for k in kernels.values():
                k.launches = 0
            enc2, (f2, _, y2), t2e, t2d = round_trip(two, imgs)
            got = {n: k.launches for n, k in kernels.items()}
        label = f"mesh batch {wire}"
        same = all(a["string_list"] == b["string_list"]
                   for a, b in zip(enc1, enc2))
        check(same, f"{label}: streams differ from one device's")
        check_round_trip(label, enc2, f2, y2)
        check(np.array_equal(f2, f1) and np.array_equal(y2, y1),
              f"{label}: decodes differ from one device's")
        check(got == {k: 2 * v for k, v in want.items()},
              f"{label}: launches {got}, expected 2 x {want}")
        held = hold_served_kernels(samples, label, card)
        counts[label] = got
        # warm, unsampled round trips in turns (one, mesh, mesh, one, ...)
        times = {id(one): [], id(two): []}
        for r in range(2 * TIMED_RUNS):
            m = (one, two)[(r + r // 2) % 2]
            times[id(m)].append(round_trip(m, imgs)[2:])
        one_ms, mesh_ms = ([float(v) * 1e3 for v in np.median(
            times[id(m)], axis=0)] for m in (one, two))
        res[wire] = {"launches": got, "held": held, "one_ms": one_ms,
                     "mesh_ms": mesh_ms,
                     "mesh_first_ms": [t2e * 1e3, t2d * 1e3]}
        print(f"{label}: 2 replicas on {card}, batch {N_IMG} of "
              f"{IMG_W}x{IMG_H}: streams byte-equal to one device's, decodes "
              f"equal, launches {got} (2 shards x {want}); encode / decode, "
              f"medians of {TIMED_RUNS} in turns, {mesh_ms[0]:.1f} / "
              f"{mesh_ms[1]:.1f} ms against one device's {one_ms[0]:.1f} / "
              f"{one_ms[1]:.1f} ms (the mesh's first call, sampled: "
              f"{t2e * 1e3:.1f} / {t2d * 1e3:.1f}; two replicas share one "
              f"card: not a scaling figure)")
    del two
    gc.collect()  # a mesh model and its replicas form a reference cycle
    torch.cuda.empty_cache()
    for m in (one,):
        m.opt["wire_format"] = "compressai"
        m.codec_setup()
    res["spatial"], counts["mesh spatial"] = spatial_mesh_check(one, mesh,
                                                                card)
    res["spatial_global"], counts["mesh spatial hific_in"] = \
        spatial_global_check(imgs, mesh, card)
    res["serve"] = mesh_serve_check(card)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    res["hyper_plans"] = hyper_plans_check(card)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"serving-mesh phase: {res['phase_s']:.1f} s [{card}]")
    return res, counts


def spatial_mesh_check(one, mesh, card: str) -> tuple:
    """One 2048x3072 still split 2 ways on the card against one device:
    the symbols apart, cross-decode both ways, peak memory (of the round
    trip, and of the analysis and the synthesis alone) and times."""
    import torch

    from crdr_tpu_torch.cli.serve_smoke import synthetic_images
    from crdr_tpu_torch.models.codec import codec_numerics
    from crdr_tpu_torch.utils.img_utils import pad_image

    kernels = kernel_wrappers()
    # what earlier phases left in reference cycles (a model and its
    # replicas, the trainers) goes first: the still's round trip peaks near
    # the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    sp = mesh_model(card, mesh, serving_devices=2,
                    serving_partition="spatial")
    big = synthetic_images(1, SPATIAL_H, SPATIAL_W, 11)
    out = {"margins": list(sp._spatial_margins),
           "plan": sp._spatial_plan(SPATIAL_H // 16, 0),
           "held_before_gib": held_gib}
    encs, decs = {}, {}
    gib = lambda: torch.cuda.max_memory_allocated() / 2 ** 30

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, gib()

    for name, m in (("whole", one), ("split", sp)):
        for k in kernels.values():
            k.launches = 0
        encs[name], enc_ms, enc_gib = peak_of(
            lambda: m.compress(big, rate_ind=RATE))
        decs[name], dec_ms, dec_gib = peak_of(
            lambda: m.decompress(encs[name]["string_list"], beta=BETA))
        launches = {n: k.launches for n, k in kernels.items()}
        ri = torch.full((1,), RATE, device=m.device)
        bt = torch.full((1,), BETA, device=m.device)
        x = torch.from_numpy(pad_image(big, m.stride)).to(m.device)
        y = torch.from_numpy(encs[name]["y_hat"]).to(m.device)
        with codec_numerics(m._chain_tf32):
            _, ana_ms, ana_gib = peak_of(lambda: m.encode_head(x, ri))
            _, syn_ms, syn_gib = peak_of(lambda: m._synthesis(y, ri, bt))
        del x, y
        out[name] = {"encode_ms": enc_ms, "decode_ms": dec_ms,
                     "peak_encode_gib": enc_gib, "peak_decode_gib": dec_gib,
                     "analysis_ms": ana_ms, "peak_analysis_gib": ana_gib,
                     "synthesis_ms": syn_ms, "peak_synthesis_gib": syn_gib,
                     "launches": launches}
        check(np.isfinite(decs[name][0]).all(), f"spatial {name}: "
              "non-finite decode")
        if not np.array_equal(decs[name][2], encs[name]["y_hat"]):
            spatial_mismatch(m, big, encs[name], decs[name], held_gib)
        check(np.array_equal(decs[name][2], encs[name]["y_hat"]),
              f"spatial {name}: decoded y_hat != its encoder's")
    apart = compare_latents(one, encs["split"]["y_hat"],
                            encs["whole"]["y_hat"])
    cross = {"whole decodes split": cross_decode(
        one, encs["split"], "spatial: one device decodes the split stream"),
        "split decodes whole": cross_decode(
        sp, encs["whole"], "spatial: the split decodes one device's stream")}
    for key, c in cross.items():
        check(c.get("equal") is True, f"spatial cross-decode ({key}): {c}")
    img_diff = float(np.abs(decs["split"][0] - decs["whole"][0]).max())
    out.update({"symbols_apart": apart["symbols_apart"],
                "streams_equal": encs["split"]["string_list"]
                == encs["whole"]["string_list"],
                "latent": apart, "cross_decode": cross,
                "image_max_abs_diff_own_streams": img_diff})
    w, sl = out["whole"], out["split"]
    print(f"mesh spatial: one {SPATIAL_W}x{SPATIAL_H} still over 2 replicas "
          f"on {card} (margins {out['margins']} latent rows, tiles "
          f"{out['plan']}; {held_gib:.2f} GiB held before): streams equal "
          f"{out['streams_equal']}, symbols "
          f"apart {apart['symbols_apart']} of {encs['whole']['y_hat'].size}; "
          f"cross-decode exact both ways; peak memory, split vs whole: "
          f"analysis {sl['peak_analysis_gib']:.2f} vs "
          f"{w['peak_analysis_gib']:.2f} GiB, synthesis "
          f"{sl['peak_synthesis_gib']:.2f} vs {w['peak_synthesis_gib']:.2f}, "
          f"the encode {sl['peak_encode_gib']:.2f} vs "
          f"{w['peak_encode_gib']:.2f}, the decode "
          f"{sl['peak_decode_gib']:.2f} vs {w['peak_decode_gib']:.2f}; ms, "
          f"split vs whole: analysis {sl['analysis_ms']:.0f} vs "
          f"{w['analysis_ms']:.0f}, synthesis {sl['synthesis_ms']:.0f} vs "
          f"{w['synthesis_ms']:.0f}, encode {sl['encode_ms']:.0f} vs "
          f"{w['encode_ms']:.0f}, decode {sl['decode_ms']:.0f} vs "
          f"{w['decode_ms']:.0f} (two replicas share one card: not a "
          f"scaling figure); launches split {sl['launches']}")
    # a 128x192 latent is past JAX's VMEM gate for the fused SliceTransform
    # (ops/slice_transform.py::fits_fused): the chain's plain f32 convs, as
    # in JAX, on either setting
    check(sl["launches"] == w["launches"] and
          sl["launches"]["slice_transform"] == 0,
          f"spatial: launches {sl['launches']} vs whole {w['launches']}")
    del sp
    torch.cuda.empty_cache()
    return out, sl["launches"]


def spatial_global_check(imgs, mesh, card: str) -> tuple:
    """The split across a global operation: HiFiC with InstanceNorm2D
    (channel_norm: False) at full width, one IMG_W x IMG_H image over 2
    replicas on the card against the same model whole, on the device wire
    with E1.  Checked: each decode equals its encoder's y_hat,
    cross-decode exact both ways, launches equal split and whole (K1 / K2
    / K3 / E1 = 0 / 2 / 0 / 2), the tiles' exchange once a norm a
    direction, nothing non-finite.  Printed: margins and tiles, streams
    equal or the symbols apart, the image's difference from the whole,
    warm encode / decode ms.  The split model is set up (its margins on the
    CPU) in a thread while the whole round trip runs on the card."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import ConfigDict

    t0 = time.perf_counter()
    kernels = kernel_wrappers()
    whole = build_family_model("hific", imgs, card, instance_norm=True,
                               wire_format="device",
                               device_wire_encoder="device")

    def split_model():
        m = build_comp_model(ConfigDict(dict(
            whole.opt.to_dict(), serving_devices=2,
            serving_partition="spatial")), device=CARD)
        m.load_state_dict(whole.state_dict())
        m.codec_setup(mesh)
        return m

    img = imgs[:1]
    want = device_wire_expected(whole, "device")
    out, encs, decs = {}, {}, {}

    def one_round(m):
        torch.cuda.synchronize()
        t = time.perf_counter()
        enc = m.compress(img)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = m.decompress(enc["string_list"])
        torch.cuda.synchronize()
        return enc, dec, (t1 - t) * 1e3, (time.perf_counter() - t1) * 1e3

    def counted(name, m):
        for k in kernels.values():
            k.launches = 0
        encs[name], decs[name], *cold = one_round(m)
        launches = {n: k.launches for n, k in kernels.items()}
        out[name] = {"launches": launches, "cold_ms": cold}
        check(launches == want, f"spatial hific_in {name}: launches "
              f"{launches}, expected {want}")
        check(np.isfinite(decs[name][0]).all(), f"spatial hific_in {name}: "
              "non-finite decode")
        check(np.array_equal(decs[name][2], encs[name]["y_hat"]),
              f"spatial hific_in {name}: decoded y_hat != its encoder's")

    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(split_model)
        counted("whole", whole)
        sp = pending.result()
    sp._exchange_rounds = [0, 0]
    counted("split", sp)
    norms = list(sp._spatial_globals)
    out["exchanges"] = list(sp._exchange_rounds)
    check(out["exchanges"] == norms, f"spatial hific_in: exchanges "
          f"{out['exchanges']} a round trip, expected one a norm {norms}")
    for name, m in (("whole", whole), ("split", sp)):  # warm, timed
        *_, e_ms, d_ms = one_round(m)
        out[name].update(encode_ms=e_ms, decode_ms=d_ms)
    apart = compare_latents(whole, encs["split"]["y_hat"],
                            encs["whole"]["y_hat"])
    cross = {"whole decodes split": cross_decode(
        whole, encs["split"], "spatial hific_in: whole decodes the split"),
        "split decodes whole": cross_decode(
        sp, encs["whole"], "spatial hific_in: the split decodes the whole")}
    for key, c in cross.items():
        check(c.get("equal") is True, f"spatial hific_in cross-decode "
              f"({key}): {c}")
    img_diff = float(np.abs(decs["split"][0].astype(np.float64)
                            - decs["whole"][0]).max())
    out.update({"margins": list(sp._spatial_margins),
                "plan": [sp._spatial_plan(IMG_H // 16, w) for w in (0, 1)],
                "norms": norms, "streams_equal": encs["split"]["string_list"]
                == encs["whole"]["string_list"],
                "symbols_apart": apart["symbols_apart"],
                "symbols": int(encs["whole"]["y_hat"].size),
                "image_max_abs_diff": img_diff, "cross_decode": cross,
                "check_s": time.perf_counter() - t0})
    w, sl = out["whole"], out["split"]
    print(f"mesh spatial hific_in: HiFiC with InstanceNorm2D, one "
          f"{IMG_W}x{IMG_H} image over 2 replicas on {card} (margins "
          f"{out['margins']} latent rows, analysis tiles {out['plan'][0]}, "
          f"synthesis tiles {out['plan'][1]}; {norms} norms, one exchange "
          f"each a direction: {out['exchanges']}): streams equal "
          f"{out['streams_equal']}, symbols apart {out['symbols_apart']} of "
          f"{out['symbols']}; image max |split - whole| {img_diff:.4g}; "
          f"cross-decode exact both ways; launches {sl['launches']} split "
          f"and whole; warm encode / decode ms, split vs whole: "
          f"{sl['encode_ms']:.1f} / {sl['decode_ms']:.1f} vs "
          f"{w['encode_ms']:.1f} / {w['decode_ms']:.1f} (cold: "
          f"{sl['cold_ms'][0]:.1f} / {sl['cold_ms'][1]:.1f} vs "
          f"{w['cold_ms'][0]:.1f} / {w['cold_ms'][1]:.1f}; two replicas "
          f"share one card: not a scaling figure); "
          f"{out['check_s']:.1f} s [{card}]")
    del sp, whole
    gc.collect()  # a mesh model and its replicas form a reference cycle
    torch.cuda.empty_cache()
    return out, sl["launches"]


HYPER_LEFT = 512 * 2 ** 20  # bytes left free around the hyper pair


def hyper_outputs(model, fn: str, z_sym) -> list:
    """``fn``'s outputs on ``z_sym`` under the codec's numerics, as host
    arrays, nested tuples flattened."""
    import torch

    from crdr_tpu_torch.models.codec import codec_numerics

    with torch.no_grad(), codec_numerics(model._chain_tf32):
        out = getattr(model, fn)(z_sym)
    torch.cuda.synchronize()
    flat, todo = [], [out]
    while todo:
        t = todo.pop(0)
        if isinstance(t, (tuple, list)):
            todo[:0] = list(t)
        else:
            flat.append(t.cpu().numpy())
    return flat


def hyper_plans_check(card: str) -> dict:
    """The hyper pair against the card's free memory (the step of phase 23
    that tests/test_torch_hyper_plans_gpu.py also runs): the flagship
    (crdr.yaml, decode_begin) and the Balle18 mean-scale model
    (generic_params) on one seeded z at 512x768 and 2048x3072, first with
    the memory free, then with a held tensor taking all of it but 512 MiB
    around _hyper_decode, and but the entry's own peak plus 512 MiB around
    the entry; every output bit-equal to the free run's."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    res = {}
    for config, entry in (("crdr.yaml", "decode_begin"),
                          ("balle18_mean_scale.yaml", "generic_params")):
        model = build_comp_model(Config.from_file(
            os.path.join(ROOT, "config", config)))
        model.codec_setup()
        cz = model.net.entropy_model_z.medians().numel()
        for h, w in ((IMG_H, IMG_W), (SPATIAL_H, SPATIAL_W)):
            rng = np.random.default_rng(16)
            z = torch.from_numpy(rng.integers(
                -4, 5, (1, h // 64, w // 64, cz)).astype(np.float32)).to(
                model.device)
            for fn in ("_hyper_decode", entry):
                free = hyper_outputs(model, fn, z)
                left = HYPER_LEFT
                if fn == entry:
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    hyper_outputs(model, fn, z)
                    left += torch.cuda.max_memory_allocated() - base
                gc.collect()
                torch.cuda.empty_cache()
                hog = torch.empty(max(torch.cuda.mem_get_info()[0] - left, 0),
                                  dtype=torch.uint8, device=model.device)
                try:
                    held = hyper_outputs(model, fn, z)
                    free_then = torch.cuda.mem_get_info()[0]
                finally:
                    del hog
                    torch.cuda.empty_cache()
                apart = sum(int(np.count_nonzero(a != b))
                            for a, b in zip(free, held))
                key = f"{config} {fn} {w}x{h}"
                res[key] = {"values": sum(a.size for a in free),
                            "apart": apart, "left_mib": left / 2 ** 20,
                            "free_under_hog_mib": free_then / 2 ** 20}
                check(len(free) == len(held) and apart == 0,
                      f"hyper pair {key}: {apart} values differ with all but "
                      f"{left / 2 ** 20:.0f} MiB of the card taken")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    print(f"hyper pair against free memory: every output bit-equal with the "
          f"card's memory taken (im2col / sub-pixel convs on the card): "
          f"{res}; {time.perf_counter() - t0:.1f} s [{card}]")
    return res


def spatial_mismatch(m, big, enc, dec, held_gib: float) -> None:
    """What a still's decode that missed its encoder's y_hat tells: how far
    apart, the numerics flags, the memory and threads around it, and
    whether a second encode and decode repeat the first ones."""
    import torch

    b = torch.backends
    apart = compare_latents(m, dec[2], enc["y_hat"])
    print(f"spatial mismatch: decode vs encoder {apart}; flags cudnn tf32 "
          f"{b.cudnn.allow_tf32} "
          f"deterministic {b.cudnn.deterministic} benchmark "
          f"{b.cudnn.benchmark}, matmul tf32 {b.cuda.matmul.allow_tf32}; "
          f"{held_gib:.2f} GiB held before, free / total "
          f"{[v / 2 ** 30 for v in torch.cuda.mem_get_info()]} GiB; threads "
          f"{sorted(t.name for t in threading.enumerate())}", flush=True)
    dec2 = m.decompress(enc["string_list"], beta=BETA)
    enc2 = m.compress(big, rate_ind=RATE)
    same = enc2["string_list"] == enc["string_list"]
    print(f"spatial mismatch: a second decode vs the first "
          f"{compare_latents(m, dec2[2], dec[2])}, vs the encoder "
          f"{compare_latents(m, dec2[2], enc['y_hat'])}; a second encode's "
          f"stream equal to the first {same}, its y_hat vs the first "
          f"{compare_latents(m, enc2['y_hat'], enc['y_hat'])}", flush=True)


def mesh_serve_check(card: str) -> dict:
    """cli/serve.py with serving_devices: 2 (CRDR_SERVING_DEVICES) and
    --mesh_devices cuda:0,cuda:0: two concurrent requests coalesce into one
    dispatch of two, one image a replica; each .bin equals the model's own
    single-device stream of the image."""
    import threading as th

    import torch

    from crdr_tpu_torch.cli import serve as serve_cli
    from crdr_tpu_torch.serving.http_server import make_server
    from crdr_tpu_torch.utils.codec_utils import unpack_byte_strings
    from crdr_tpu_torch.utils.img_utils import encode_png

    dev = card_device()
    os.environ["CRDR_SERVING_DEVICES"] = "2"
    try:
        model = serve_cli.build_model(serve_cli.parse_args(
            [os.path.join(ROOT, "config", "crdr_throughput.yaml"), "-d",
             str(dev), "--mesh_devices", f"{dev},{dev}"]))
    finally:
        del os.environ["CRDR_SERVING_DEVICES"]
    check(len(model._replicas) == 2, "serve CLI: no serving mesh")
    imgs = smooth_images(5)[:2]
    srv = make_server(model, port=0, max_batch=4, max_wait_s=2.0)
    th.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        got = [None, None]

        def send(i):
            got[i] = http_post(f"{base}/compress?q={RATE}",
                               encode_png(imgs[i]))

        threads = [th.Thread(target=send, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        hist = srv.batcher.stats()["batch_hist"]
    finally:
        srv.shutdown()
        srv.batcher.close()
    for i, reply in enumerate(got):
        want = model.compress(imgs[i:i + 1], rate_ind=RATE)["string_list"]
        check(reply is not None and unpack_byte_strings(reply[0]) == want,
              f"serve CLI mesh: request {i} differs from the stream alone")
    check(hist == {2: 1}, f"serve CLI mesh: dispatches {hist}")
    print(f"serve CLI (serving_devices 2, --mesh_devices {dev},{dev}): "
          f"two requests in one dispatch of 2, one image a replica, each "
          f".bin equal to the image's stream alone [{card}]")
    del model
    torch.cuda.empty_cache()
    return {"batch_hist": {str(k): v for k, v in hist.items()}}


# ---------------- phase 24: AOT serving packages ---------------------------

AOT_SHAPES = ((N_IMG, IMG_H, IMG_W), (1, IMG_H, IMG_W))
AOT_TURNS = 3        # warm served requests a server, in turns
# the flagship's package: the device wire at the batch bucket only (the
# served one-image requests of the cold start run on the compressai wire)
AOT_FLAGSHIP_SHAPES = {"compressai": AOT_SHAPES, "device": AOT_SHAPES[:1]}
# the GDN package's bucket for the CPU process (the CPU's passes at 512x768
# would be most of the phase)
AOT_CPU_H, AOT_CPU_W = 256, 384
AOT_CPU_THREADS = 4  # the CPU process's threads, beside the card work
# the programs whose shapes follow the data (the lane words' length): they
# may miss at a recorded bucket and run live, as in JAX
AOT_DATA_SHAPED = {"rans_round"}
OP_NAMES = {"slice_transform": "slice_transform",
            "lane_decode_round": "lane_decode_round",
            "gdn": "gdn", "lane_encode": "lane_encode_rounds"}


@contextlib.contextmanager
def sampled_op_calls():
    """Within the block, keeps the first call of each kernel's op
    (``crdr::*``, as the live path and a package's programs both call it)
    at each input shape: {wrapper name: {shape: (arguments, output)}},
    tensors cloned.  Every call runs, and counts, as it would."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    samples = {name: {} for name in OP_NAMES.values()}

    def clone(v):
        return v.detach().clone() if torch.is_tensor(v) else v

    class Sampler(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = OP_NAMES.get(func._opname) \
                if func.namespace == "crdr" else None
            if name is not None:
                key = tuple(tuple(a.shape) if torch.is_tensor(a) else a
                            for a in args if not isinstance(a, list))
                if key not in samples[name]:
                    samples[name][key] = (
                        [clone(a) for a in args],
                        tuple(map(clone, out)) if isinstance(out, tuple)
                        else clone(out))
            return out

    with Sampler():
        yield samples


def hold_op_calls(samples, label: str, card: str) -> dict:
    """Each sampled op call's output against the kernel's plain twin on the
    same inputs: K1 within K1_ATOL, K2 and E1 exactly, K3 within
    K3_RTOL |plain| + K3_ATOL.  Returns {kernel: {calls, max_abs_err}}."""
    import torch

    from crdr_tpu_torch.ops import device_rans
    from crdr_tpu_torch.ops.gdn import gdn_plain
    from crdr_tpu_torch.ops.slice_transform import slice_transform_plain

    def k1(args, out):
        x, *stacks, idx = args
        plain = slice_transform_plain(x, *(t[idx] for t in stacks))
        err = float((out - plain).abs().max())
        return bool(torch.isfinite(out).all()) and err <= K1_ATOL, err

    def k2(args, out):
        st, pt, words, idx, cdf, ln, off, _buf, _bits, m = args
        ref = device_rans.lane_decode_round_instep(st, pt, words, idx, cdf,
                                                   ln, off, m)
        return all(torch.equal(a, b) for a, b in zip(out, ref)), 0.0

    def e1(args, out):
        ref = device_rans.lane_encode_walk(*args)
        return all(torch.equal(a, b) for a, b in zip(out, ref)), 0.0

    def k3(args, out):
        ref = gdn_plain(*args)
        excess = float(((out - ref).abs() / (K3_RTOL * ref.abs() + K3_ATOL))
                       .max())
        return excess <= 1.0, float((out - ref).abs().max())

    twins = {"slice_transform": k1, "lane_decode_round": k2,
             "lane_encode_rounds": e1, "gdn": k3}
    held = {}
    for name, twin in twins.items():
        for key, (args, out) in samples[name].items():
            ok, err = twin(args, out)
            check(ok, f"{label}: {name}'s op at {key} != its plain twin "
                      f"(max |err| {err:.3e})")
            row = held.setdefault(name, {"calls": 0, "max_abs_err": 0.0})
            row["calls"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
    return held


def aot_export(model, path: str, wires: dict, label: str, card: str,
               platforms=("cuda",)) -> dict:
    """Record the model's serving round trips on each wire of ``wires``
    ({wire: shapes}; E1 encoding the device wire) at its shapes, export
    them for ``platforms`` into ``path``; every cuda entry must export.
    Returns the figures."""
    import torch

    from crdr_tpu_torch.runtime.aot import (export_package,
                                            record_serving_roundtrip)

    t0 = time.perf_counter()
    for wire, shapes in wires.items():
        model.opt["wire_format"] = wire
        model.opt["device_wire_encoder"] = "device"
        model.codec_setup()
        for b, h, w in shapes:
            record_serving_roundtrip(model, b, h, w, rate_ind=RATE,
                                     beta=BETA)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    man = export_package(model, path, platforms=platforms)
    t2 = time.perf_counter()
    model._aot.recorder = None
    skipped = {p: [s for s in man["skipped"] if s["platform"] == p]
               for p in ("cuda", "cpu")}
    check(not skipped["cuda"], f"{label}: cuda programs did not export: "
                               f"{skipped['cuda'][:2]}")
    by = {p: [e for e in man["entries"] if e["platform"] == p]
          for p in ("cuda", "cpu")}
    res = {"record_s": t1 - t0, "export_s": t2 - t1,
           "programs": len(by["cuda"]), "cpu_programs": len(by["cpu"]),
           "cpu_skipped": len(skipped["cpu"]),
           "cpu_errors": sorted({s["error"][:200] for s in skipped["cpu"]}),
           "bytes": sum(e["bytes"] for e in by["cuda"]),
           "cpu_bytes": sum(e["bytes"] for e in by["cpu"]),
           "names": sorted({e["name"] for e in by["cuda"]})}
    print(f"{label}: recorded {wires} in {res['record_s']:.1f}"
          f" s, exported {res['programs']} cuda programs ({res['bytes']} B) "
          f"and {res['cpu_programs']} cpu ({res['cpu_bytes']} B, "
          f"{len(skipped['cpu'])} skipped) in {res['export_s']:.1f} s "
          f"[{card}]")
    return res


def set_wire(models, wire: str) -> None:
    for m in models:
        m.opt["wire_format"] = wire
        m.opt["device_wire_encoder"] = "device"
        m.codec_setup()


def aot_compare(live, fresh, imgs, wire: str, label: str, expected: dict,
                card: str, batch1: bool = True) -> tuple:
    """``fresh`` (the package loaded) against ``live`` (the same weights, no
    package) on ``wire``: a batch round trip with launches counted and the
    ops' calls held against their twins, then (with ``batch1``) a batch-1
    round trip; streams byte-equal, decodes pixel-equal, y_hat equal to the
    encoder's, launches = ``expected`` on both, no miss but in
    AOT_DATA_SHAPED.  Returns (figures, launches)."""
    from crdr_tpu_torch.runtime.aot import aot_counts

    set_wire((live, fresh), wire)
    base = aot_counts(fresh)
    encs_l, (f_l, _, y_l), _, _, got_l = counted_round_trip(live, imgs)
    with sampled_op_calls() as samples:
        encs_p, (f_p, _, y_p), _, _, got_p = counted_round_trip(fresh, imgs)
    check(all(a["string_list"] == b["string_list"]
              for a, b in zip(encs_l, encs_p)),
          f"{label}: package streams != live streams")
    check(np.array_equal(f_l, f_p) and np.array_equal(y_l, y_p),
          f"{label}: package decode != live decode")
    check_round_trip(label, encs_p, f_p, y_p)
    check(got_l == expected and got_p == expected,
          f"{label}: launches live {got_l}, package {got_p}, expected "
          f"{expected}")
    held = hold_op_calls(samples, label, card)
    rate = {"rate_ind": RATE} if live.use_rate else {}
    beta = {"beta": BETA} if live.use_beta else {}
    if batch1:
        one_l = live.compress_batch(imgs[:1], **rate)[0]["string_list"]
        one_p = fresh.compress_batch(imgs[:1], **rate)[0]["string_list"]
        check(one_l == one_p == encs_p[0]["string_list"],
              f"{label}: batch-1 package stream != live / batch stream")
        d1 = fresh.decompress_batch([one_p], **beta)
        check(np.array_equal(d1[0][0], f_p[0]),
              f"{label}: batch-1 package decode != the batch decode")
    counts = {n: {k: c[k] - base.get(n, {}).get(k, 0) for k in c}
              for n, c in aot_counts(fresh).items()}
    missed = {n: c["misses"] for n, c in counts.items()
              if c["misses"] and n not in AOT_DATA_SHAPED}
    check(not missed, f"{label}: misses at the recorded buckets: {missed}")
    check(sum(c["hits"] for c in counts.values()) > 0,
          f"{label}: no dispatch ran from the package")
    print(f"{label}: streams byte-equal to the live path (batch {N_IMG}"
          f"{' and 1' if batch1 else ''}), decodes equal, launches {got_p} = "
          f"live's; hits / misses "
          f"{counts}; ops held against their twins {held} [{card}]")
    return {"counts": counts, "held": held, "launches": got_p}, got_p


def aot_turns(live, fresh, imgs, wire: str, label: str, card: str,
              sizes=(N_IMG, 1)) -> dict:
    """Round trips of ``live`` and ``fresh`` (the package) on ``wire`` in
    turns, at the batch ``sizes``: medians of TIMED_RUNS (encode / decode
    ms) and the last decode's parts."""
    set_wire((live, fresh), wire)
    times = {(k, n): [] for k in ("live", "package") for n in sizes}
    parts = {}
    for r in range(2 * TIMED_RUNS):
        m, k = ((live, "live"), (fresh, "package"))[(r + r // 2) % 2]
        for n in sizes:
            times[k, n].append([v * 1e3 for v in round_trip(m, imgs[:n])[2:]])
        parts[k] = {name: v * 1e3 for name, v in m.last_decode_timing.items()}
    med = {f"{k} batch {n}": [float(v) for v in np.median(t, axis=0)]
           for (k, n), t in times.items()}
    print(f"{label}: encode / decode ms, medians of {TIMED_RUNS} in turns: "
          + ", ".join(f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in med.items())
          + f"; the last decode's parts, ms: {parts} [{card}]")
    return {"ms": med, "decode_parts_ms": parts}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(pkg, log_path: str) -> dict:
    """cli/serve.py on crdr_throughput.yaml (seeded init) in a fresh
    process, with ``--aot_package pkg`` when given; returns its handle
    (``first_answer`` waits for it)."""
    port = free_port()
    cmd = [sys.executable, "-m", "crdr_tpu_torch.cli.serve",
           os.path.join(ROOT, "config", "crdr_throughput.yaml"), "--port",
           str(port)] + (["--aot_package", pkg] if pkg else [])
    with open(log_path, "wb") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT)
    return {"proc": proc, "t0": t0, "log": log_path, "pkg": pkg,
            "base": f"http://127.0.0.1:{port}"}


def first_answer(srv: dict, body: bytes) -> None:
    """Waits for the server's /healthz, then sends its first /compress;
    sets the seconds (from its start) to listening and to that answer, and
    the .bin."""
    import urllib.request

    listen = None
    while time.perf_counter() - srv["t0"] < 300:
        if srv["proc"].poll() is not None:
            break
        try:
            with urllib.request.urlopen(f"{srv['base']}/healthz", timeout=5):
                listen = time.perf_counter() - srv["t0"]
                break
        except OSError:
            time.sleep(0.05)
    if listen is None:
        with open(srv["log"], "rb") as f:
            tail = f.read()[-3000:].decode(errors="replace")
        fail(f"serve {'with' if srv['pkg'] else 'without'} a package did "
             f"not listen:\n{tail}")
    srv["blob"] = http_post(f"{srv['base']}/compress?q={RATE}", body)[0]
    srv["listen_s"] = listen
    srv["first_compress_s"] = time.perf_counter() - srv["t0"]


def cold_start_begin(pkg: str) -> dict:
    """cli/serve.py in two fresh processes started together, without and
    with the package (the kernel libraries built by phase 1 both times),
    and a thread each that waits for its first /compress answer
    (``first_answer``).  Returns the servers; ``cold_start_end`` finishes."""
    import threading as th

    from crdr_tpu_torch.utils.img_utils import encode_png

    logs = os.path.join(ROOT, "build")
    body = encode_png(smooth_images(7)[0])
    srvs = {}
    for tag, p in (("live", None), ("package", pkg)):
        srvs[tag] = start_server(p, os.path.join(logs, f"aot_serve_{tag}.log"))
        srvs[tag]["waiter"] = th.Thread(target=first_answer,
                                        args=(srvs[tag], body))
        srvs[tag]["waiter"].start()
    srvs["body"] = body
    return srvs


def cold_start_end(srvs: dict, card: str) -> dict:
    """The servers of ``cold_start_begin``: seconds to listening and to the
    first /compress answer; then warm /compress and /decompress requests of
    one 512x768 image, the two servers in turns; the package's .bin equal
    to the live server's; both stopped."""
    body = srvs.pop("body")
    try:
        for srv in srvs.values():
            srv.pop("waiter").join()
        check(all("blob" in srv for srv in srvs.values()),
              "cold start: a server gave no first answer")
        check(srvs["live"]["blob"] == srvs["package"]["blob"],
              "cold start: the served .bin differs with the package")
        for srv in srvs.values():
            srv["compress_ms"], srv["decompress_ms"] = [], []
        for r in range(2 * AOT_TURNS):
            srv = srvs[("live", "package")[(r + r // 2) % 2]]
            blob, _, dt = http_post(f"{srv['base']}/compress?q={RATE}", body)
            srv["compress_ms"].append(dt * 1e3)
            srv["decompress_ms"].append(http_post(
                f"{srv['base']}/decompress?beta={BETA}", blob)[2] * 1e3)
        srvs["package"]["aot"] = get_json(
            f"{srvs['package']['base']}/healthz")["aot"]
    finally:
        for srv in srvs.values():
            srv["proc"].terminate()
        for srv in srvs.values():
            try:
                srv["proc"].wait(timeout=30)
            except subprocess.TimeoutExpired:
                srv["proc"].kill()
                srv["proc"].wait()
    out = {}
    for tag, srv in srvs.items():
        out[tag] = {"listen_s": srv["listen_s"],
                    "first_compress_s": srv["first_compress_s"],
                    "compress_ms": float(np.median(srv["compress_ms"])),
                    "decompress_ms": float(np.median(srv["decompress_ms"])),
                    "compress_runs_ms": srv["compress_ms"],
                    "decompress_runs_ms": srv["decompress_ms"],
                    "aot": srv.get("aot")}
        print(f"cold start, cli/serve.py {tag} (both started together, "
              f"while the phase's other packages export): listening after "
              f"{srv['listen_s']:.2f} s, first /compress answered after "
              f"{srv['first_compress_s']:.2f} s; warm one-image /compress / "
              f"/decompress ms, medians of {AOT_TURNS} in turns (nothing "
              f"else running): {out[tag]['compress_ms']:.1f} / "
              f"{out[tag]['decompress_ms']:.1f}"
              + (f"; hits / misses {srv['aot']}" if srv.get("aot") else "")
              + f" [{card}]")
    return out


def aot_cpu_child(pkg: str) -> None:
    """The cross-platform check's process (on the CPU): the GDN path's model
    (balle18_mean_scale.yaml, seeded init on the CPU), one AOT_CPU_H x
    AOT_CPU_W image encoded and decoded live and through the package's cpu
    programs (a second model, the same weights); prints one JSON line."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.runtime.aot import aot_counts, load_package
    from crdr_tpu_torch.utils.config import Config

    cfg = os.path.join(ROOT, "config", "balle18_mean_scale.yaml")
    live, pkgd = (build_comp_model(Config.from_file(cfg), device="cpu")
                  for _ in range(2))
    pkgd.load_state_dict(live.state_dict())
    for m in (live, pkgd):
        m.codec_setup()
    load_package(pkgd, pkg)
    img = np.ascontiguousarray(smooth_images(7)[:1, :AOT_CPU_H, :AOT_CPU_W])
    t0 = time.perf_counter()
    a = live.compress_batch(img)[0]
    t1 = time.perf_counter()
    b = pkgd.compress_batch(img)[0]
    t2 = time.perf_counter()
    fa = live.decompress_batch([a["string_list"]])[0]
    fb = pkgd.decompress_batch([b["string_list"]])[0]
    print(json.dumps({"streams_equal": a["string_list"] == b["string_list"],
                      "decodes_equal": bool(np.array_equal(fa, fb)),
                      "live_encode_s": t1 - t0, "package_encode_s": t2 - t1,
                      "counts": aot_counts(pkgd),
                      "threads": torch.get_num_threads()}))


def aot_cpu_start(pkg: str) -> tuple:
    """Starts the cross-platform check's CPU process (``aot_cpu_child``, at
    AOT_CPU_THREADS threads, beside the card work that follows); returns
    (process, start time)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS=str(AOT_CPU_THREADS))
    return subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.aot_cpu_child(sys.argv[1])", pkg], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.perf_counter()


def aot_cpu_result(started: tuple, card: str) -> dict:
    """The CPU process's line: the package's cpu programs against the CPU
    live path (measured, as phase 17: printed, not asserted)."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    try:
        res = json.loads(out.strip().splitlines()[-1])
    except (IndexError, ValueError):
        res = {"error": (err or out)[-600:]}
    res["process_s"] = time.perf_counter() - t0
    print(f"cross-platform: the package's cpu programs in a CPU process "
          f"({AOT_CPU_THREADS} threads, beside the phase's card work) vs "
          f"the CPU live path: {json.dumps(res)} [{card}]")
    return res


def aot_child(kind: str, path: str) -> None:
    """One package of phase 24 in its own process on the card, beside the
    flagship's: ``gdn``, the GDN path (balle18_mean_scale.yaml) at
    AOT_SHAPES and 1xAOT_CPU_HxAOT_CPU_W, exported for cuda and cpu, its
    cpu programs then held in a CPU process (``aot_cpu_child``); or ``cb``,
    the checkerboard (cb_stage2.yaml) at AOT_SHAPES' batch bucket only (its
    export of 108 programs a bucket was the phase's longest leg).  Both on
    the compressai wire; the package loaded into a fresh model on the same
    weights and held against the live path (``aot_compare``; the GDN path
    at batch 1 too).  Prints its lines, then one line ``aot_child {json}``;
    a failed check exits non-zero."""
    sys.path.insert(0, ROOT)
    import torch

    from crdr_tpu_torch.runtime.aot import load_package

    card = card_line()
    imgs = smooth_images(7)
    cpu_check = None
    if kind == "gdn":
        live = build_gdn_model(imgs, card)
        export = aot_export(live, path, {"compressai": AOT_SHAPES + (
            (1, AOT_CPU_H, AOT_CPU_W),)}, "aot GDN path", card,
            ("cuda", "cpu"))
        cpu_check = aot_cpu_start(path)
        fresh = build_gdn_model(imgs, card)
        want = {"slice_transform": 0, "lane_decode_round": 0, "gdn": 6,
                "lane_encode_rounds": 0}
        label = "aot GDN path compressai"
    else:
        live = cb_model(card)
        export = aot_export(live, path, {"compressai": AOT_SHAPES[:1]},
                            "aot checkerboard", card)
        fresh = cb_model(card)
        want = {"slice_transform": 6 * live.num_slices,
                "lane_decode_round": 0, "gdn": 0, "lane_encode_rounds": 0}
        label = "aot checkerboard compressai"
    load_package(fresh, path)
    compare, launches = aot_compare(live, fresh, imgs, "compressai", label,
                                    want, card, batch1=kind == "gdn")
    out = {"label": label, "export": export, "compare": compare,
           "launches": launches}
    del live, fresh
    torch.cuda.empty_cache()
    if cpu_check is not None:
        out["cross_platform"] = aot_cpu_result(cpu_check, card)
    print("aot_child " + json.dumps(out), flush=True)


def aot_child_start(kind: str, path: str) -> dict:
    """Starts ``aot_child(kind, path)``, its output to a file beside the
    package."""
    child = start_proc([sys.executable, "-c", "import sys, chip_smoke; "
                        "chip_smoke.aot_child(sys.argv[1], sys.argv[2])",
                        kind, path], ROOT, path + ".log")
    child["kind"] = kind
    return child


def aot_child_end(child: dict) -> dict:
    """Waits for a child of ``aot_child_start``, prints its lines, and
    returns its figures (its ``process_s`` added); fails if it failed."""
    rc, out, process_s = end_proc(child, timeout=900)
    lines = out.splitlines()
    res = None
    for line in lines:
        if line.startswith("aot_child "):
            res = json.loads(line[len("aot_child "):])
        else:
            print(line)
    check(rc == 0 and res is not None, f"phase 24's {child['kind']} "
          f"process failed (exit {rc}): {lines[-5:]}")
    res["process_s"] = process_s
    return res


def aot_phase(imgs, card: str) -> tuple:
    """Phase 24: AOT serving packages (module doc).  The GDN path's and the
    checkerboard's packages are made and held in processes of their own
    (``aot_child``) while this one makes and holds the flagship's and the
    two servers start; the timed turns (in process and served) run after
    those processes end, with nothing else running."""
    import tempfile

    import torch

    from crdr_tpu_torch.runtime.aot import aot_counts, load_package

    t_phase = time.perf_counter()
    res, counts = {}, {}
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        children = [aot_child_start(k, os.path.join(tmp, k))
                    for k in ("gdn", "cb")]
        servers = None
        try:
            flag = os.path.join(tmp, "flagship")
            live = build_model(card)
            res["flagship_export"] = aot_export(
                live, flag, AOT_FLAGSHIP_SHAPES, "aot flagship", card)
            servers = cold_start_begin(flag)
            fresh = build_model(card)
            t0 = time.perf_counter()
            load_package(fresh, flag)
            res["flagship_load_s"] = time.perf_counter() - t0
            for wire in ("compressai", "device"):
                label = f"aot flagship {wire}"
                want = device_wire_expected(live, "device") \
                    if wire == "device" else {
                        "slice_transform": 6 * live.num_slices,
                        "lane_decode_round": 0, "gdn": 0,
                        "lane_encode_rounds": 0}
                res[label], counts[label] = aot_compare(
                    live, fresh, imgs, wire, label, want, card,
                    batch1=len(AOT_FLAGSHIP_SHAPES[wire]) > 1)
            # phase 23's batch mesh with the package: 8 images, a recorded
            # bucket of 4 a replica
            two = mesh_model(card, [card_device()] * 2, serving_devices=2)
            load_package(two, flag)
            set_wire((live, two), "compressai")
            eight = np.concatenate([imgs, imgs[::-1]])
            want = live.compress_batch(eight, rate_ind=RATE)
            got = two.compress_batch(eight, rate_ind=RATE)
            check([e["string_list"] for e in want] ==
                  [e["string_list"] for e in got],
                  "aot mesh: package streams != one device's live streams")
            f2 = two.decompress_batch([e["string_list"] for e in got],
                                      beta=BETA)
            check_round_trip("aot mesh", got[:N_IMG], f2[0][:N_IMG],
                             f2[2][:N_IMG])
            res["mesh"] = {"counts": aot_counts(two)}
            print(f"aot mesh: 2 replicas on {card_device()}, 8 images of "
                  f"{IMG_W}x{IMG_H} (4 a replica): streams byte-equal to one "
                  f"device's live streams; hits / misses "
                  f"{res['mesh']['counts']} [{card}]")
            del two
            gc.collect()
            torch.cuda.empty_cache()
            for child in children:
                out = aot_child_end(child)
                label = out.pop("label")
                key = "gdn" if child["kind"] == "gdn" else "cb"
                res[f"{key}_export"] = out.pop("export")
                res[label] = out.pop("compare")
                counts[label] = out.pop("launches")
                res[f"{key}_process_s"] = out.pop("process_s")
                if "cross_platform" in out:
                    res["cross_platform"] = out.pop("cross_platform")
            children = []
            for wire in ("compressai", "device"):
                label = f"aot flagship {wire}"
                res[label].update(aot_turns(
                    live, fresh, imgs, wire, label, card,
                    [b for b, _, _ in AOT_FLAGSHIP_SHAPES[wire]]))
            del live, fresh
            torch.cuda.empty_cache()
            res["cold_start"] = cold_start_end(servers, card)
            servers = None
        finally:
            for child in children:
                child["proc"].kill()
                child["proc"].wait()
            for srv in (servers or {}).values():
                if isinstance(srv, dict):
                    srv["proc"].kill()
                    srv["proc"].wait()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"AOT phase: {res['phase_s']:.1f} s [{card}]")
    return res, counts


# ---------------- phase 25: JPEG input --------------------------------------

JPEG_DIR = os.path.join(ROOT, "tests", "data", "jpeg")
PNG_DIR = os.path.join(ROOT, "tests", "data", "png")
BMP_DIR = os.path.join(ROOT, "tests", "data", "bmp")
# the formats whose digests name cv2's file reading "cv2" (and PIL's body
# reading "body")
BODY_DIRS = {kind: os.path.join(ROOT, "tests", "data", kind.lower())
             for kind in ("WebP", "GIF", "PNM", "TIFF", "JPEG2000", "SunRas",
                          "HDR")}
JPEG_STEPS = 3


def pixel_sha(img) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def fixtures_check(folder: str, twin=None) -> dict:
    """Every fixture of ``folder`` (tests/data/jpeg, png or bmp) decoded on
    both paths (``read_image``: cv2's, for files; ``decode_image(...,
    file_path=False)``: PIL's, for request bodies), its pixels' sha256
    against the digests cv2 and PIL gave; the refused ones raise their
    reason.  ``twin(data, name, file_path)``, when given, decodes each
    fixture under 100 kB again, equal on both paths (the C++ PNG decoder's
    numpy twin; the 768x512 photos are ``png_decode_timing``'s)."""
    from crdr_tpu_torch.utils.img_utils import decode_image, read_image

    with open(os.path.join(folder, "digests.json")) as f:
        digests = json.load(f)
    done = refused = twins = truncated = 0
    for name, want in sorted(digests.items()):
        path = os.path.join(folder, name)
        if "body_raises" in want:  # a truncated JPEG: cv2 reads the file
            img = read_image(path)
            check(list(img.shape) == want["file_shape"] and
                  pixel_sha(img) == want["file"],
                  f"{name}: the file path's pixels differ from cv2's")
            with open(path, "rb") as f:
                data = f.read()
            try:
                decode_image(data, name, file_path=False)
            except ValueError as e:
                check(want["body_raises"] in str(e),
                      f"{name}: the body raised {e!r}")
            else:
                fail(f"{name}: the body path read it, PIL refuses it")
            truncated += 1
            continue
        if "raises" in want:
            try:
                read_image(path)
            except ValueError as e:
                check(want["raises"] in str(e),
                      f"{name}: raised {e!r}, not {want['raises']!r}")
                refused += 1
                continue
            fail(f"{name}: decoded, but the port refuses it "
                 f"({want['raises']})")
        with open(path, "rb") as f:
            data = f.read()
        if "body" not in want:  # PIL refuses it (a BMP cv2 reads)
            try:
                decode_image(data, name, file_path=False)
            except ValueError:
                refused += 1
            else:
                fail(f"{name}: the body path read it, PIL refuses it")
        for path_kind, img in (
                ("file", read_image(path)),
                *((("body", decode_image(data, name, file_path=False)),)
                  if "body" in want else ())):
            check(list(img.shape) == want[f"{path_kind}_shape"] and
                  pixel_sha(img) == want[path_kind],
                  f"{name}: the {path_kind} path's pixels differ from "
                  f"{'cv2' if path_kind == 'file' else 'PIL'}'s")
            if twin is not None and len(data) < 100_000:
                check(np.array_equal(twin(data, name, path_kind == "file"),
                                     img),
                      f"{name}: the numpy twin's {path_kind} pixels differ")
                twins += 1
        done += 1
    return {"decoded": done, "refused": refused, "twin_checked": twins,
            "truncated": truncated}


def body_fixtures_check(kind: str) -> dict:
    """Every fixture of tests/data/<kind> (WebP, GIF, PNM, TIFF, JPEG2000,
    SunRas, HDR) on both paths: on the file path its pixels' sha256 equal
    to cv2's digest, or refused where cv2 returns None (or by name,
    ``file_refused``: CCITT, which cv2 reads); on the body path equal to
    PIL's digest, or refused with its reason (what PIL refuses, and what
    the port refuses by name)."""
    import re

    from crdr_tpu_torch.utils.img_utils import decode_image

    folder = BODY_DIRS[kind]
    with open(os.path.join(folder, "digests.json")) as f:
        digests = json.load(f)
    done = {"file": 0, "body": 0}
    refused = {"file": 0, "body": 0}
    for name, want in sorted(digests.items()):
        with open(os.path.join(folder, name), "rb") as f:
            data = f.read()
        for path_kind, sha, why in (
                ("file", want["cv2"], want.get("file_refused", "")),
                ("body", want.get("body"), want.get("refused"))):
            try:
                img = decode_image(data, name, file_path=path_kind == "file")
            except ValueError as e:
                check((sha is None or why) and re.search(why or "", str(e))
                      is not None, f"{name}: raised {e!r} on the "
                      f"{path_kind} path")
                refused[path_kind] += 1
                continue
            check(sha is not None and not why, f"{name}: read on the "
                  f"{path_kind} path, where its oracle or the port refuses "
                  "it")
            check(pixel_sha(img) == sha and (path_kind == "file" or list(
                img.shape) == want["body_shape"]), f"{name}: the "
                f"{path_kind} path's pixels differ from "
                f"{'cv2' if path_kind == 'file' else 'PIL'}'s")
            done[path_kind] += 1
    return {"decoded": done, "refused": refused}


def body_decode_timing() -> dict:
    """The C++ WebP decoder (lossy and lossless) and the GIF reader on the
    card's host at 768x512, of serve_smoke's synthetic_images(1, 512, 768,
    25): ms a decode, medians of 12 after 2 warm-up; the lossless WebP
    equal to those pixels, each equal to PIL's digest."""
    from crdr_tpu_torch.cli.serve_smoke import synthetic_images
    from crdr_tpu_torch.utils.gif import decode_gif
    from crdr_tpu_torch.utils.webp import decode_webp

    pixels = synthetic_images(1, 512, 768, 25)[0]
    res = {}
    for kind, name, decode in (
            ("webp_lossy", "photo_768x512_lossy.webp", decode_webp),
            ("webp_lossless", "photo_768x512_lossless.webp", decode_webp),
            ("gif", "photo_768x512.gif", decode_gif)):
        folder = BODY_DIRS["GIF" if kind == "gif" else "WebP"]
        with open(os.path.join(folder, name), "rb") as f:
            data = f.read()
        with open(os.path.join(folder, "digests.json")) as f:
            want = json.load(f)[name]["body"]
        runs = []
        for _ in range(14):
            t0 = time.perf_counter()
            img = decode(data, name)
            runs.append((time.perf_counter() - t0) * 1e3)
        check(pixel_sha(img) == want, f"{name}: pixels differ from PIL's")
        if kind == "webp_lossless":
            check(np.array_equal(img, pixels), f"{name}: not the pixels of "
                  "synthetic_images(1, 512, 768, 25)")
        res[kind] = {"ms": float(np.median(runs[2:])), "bytes": len(data)}
    return res


def truncated_dataset_check(tmp: str) -> dict:
    """The truncated JPEG fixtures in a train_0/ read through
    OpenImageImageDataset (uint8), each equal to cv2's digest (JAX's
    loader reads them with cv2.imread)."""
    from crdr_tpu_torch.data.datasets import OpenImageImageDataset

    with open(os.path.join(JPEG_DIR, "digests.json")) as f:
        digests = json.load(f)
    names = sorted(n for n, d in digests.items() if "body_raises" in d)
    train0 = os.path.join(tmp, "truncated", "train_0")
    os.makedirs(train0)
    for n in names:
        shutil.copy(os.path.join(JPEG_DIR, n), train0)
    ds = OpenImageImageDataset(os.path.dirname(train0), [0], is_train=True,
                               uint8_io=True)
    check(len(ds) == len(names), f"the truncated tree: {len(ds)} images")
    for i, n in enumerate(names):
        img = ds._load(i)
        check(pixel_sha(img) == digests[n]["file"],
              f"{n} through OpenImageImageDataset: pixels differ from cv2's")
    return {"files": len(names)}


def decode_timing_768x512() -> dict:
    """The file path's slower readers on the card's host at 768x512, ms a
    decode (medians of 5 after 1 warm-up), each decode's pixels against
    its committed digest: arithmetic-coded JPEG, sequential and
    progressive, a progressive JPEG libjpeg smooths (its refinement scans
    cut out), YCbCr 4:2:0 JPEG inside TIFF, GIF and 16-bit TIFF, all on
    the file path (cv2's reading)."""
    from crdr_tpu_torch.utils.img_utils import decode_image

    res = {}
    for kind, folder, name in (
            ("arith_seq", JPEG_DIR, "arith_seq_768x512.jpg"),
            ("arith_prog", JPEG_DIR, "arith_prog_768x512.jpg"),
            ("smoothed_prog", JPEG_DIR, "smooth_768x512.jpg"),
            ("jpeg_in_tiff_420", BODY_DIRS["TIFF"],
             "photo_768x512_jpeg_420.tif"),
            ("gif_file", BODY_DIRS["GIF"], "photo_768x512.gif"),
            ("tiff_16bit_file", BODY_DIRS["TIFF"],
             "photo_768x512_16bit.tif")):
        with open(os.path.join(folder, name), "rb") as f:
            data = f.read()
        with open(os.path.join(folder, "digests.json")) as f:
            d = json.load(f)[name]
        runs = []
        for _ in range(6):
            t0 = time.perf_counter()
            img = decode_image(data, name, file_path=True)
            runs.append((time.perf_counter() - t0) * 1e3)
        check(img.shape == (512, 768, 3) and
              pixel_sha(img) == d.get("cv2", d.get("file")),
              f"{name}: the file path's pixels differ from cv2's")
        res[kind] = {"ms": float(np.median(runs[1:])), "bytes": len(data)}
    return res


def new_readers_timing() -> dict:
    """The JPEG 2000, Sun raster and Radiance readers on the card's host at
    768x512 (serve_smoke's synthetic_images(1, 512, 768, 25)): ms a
    decode, medians of 3 after 1 warm-up, each decode's pixels against its
    committed digest: a reversible JP2, an irreversible codestream of two
    quality layers and an irreversible JP2 in 256x256 RPCL tiles (the file
    path, cv2's), the run-length Sun raster (the body path, PIL's: cv2
    reads no run-length Sun raster) and the run-length Radiance file (the
    file path)."""
    from crdr_tpu_torch.utils.img_utils import decode_image

    res = {}
    for kind, folder, name, file_path in (
            ("jp2_reversible", "JPEG2000", "photo_768x512_reversible.jp2",
             True),
            ("j2k_irreversible", "JPEG2000", "photo_768x512_layers.j2k",
             True),
            ("jp2_tiled_rpcl", "JPEG2000", "photo_768x512_tiled_rpcl.jp2",
             True),
            ("sunras_rle_body", "SunRas", "photo_768x512_rle.ras", False),
            ("hdr_rle", "HDR", "photo_768x512_rle.hdr", True)):
        folder = BODY_DIRS[folder]
        with open(os.path.join(folder, name), "rb") as f:
            data = f.read()
        with open(os.path.join(folder, "digests.json")) as f:
            want = json.load(f)[name]["cv2" if file_path else "body"]
        runs = []
        for _ in range(4):
            t0 = time.perf_counter()
            img = decode_image(data, name, file_path=file_path)
            runs.append((time.perf_counter() - t0) * 1e3)
        check(img.shape == (512, 768, 3) and pixel_sha(img) == want,
              f"{name}: pixels differ from {'cv2' if file_path else 'PIL'}'s")
        res[kind] = {"ms": float(np.median(runs[1:])), "bytes": len(data)}
    return res


def sun_raster(rgb) -> bytes:
    """A standard (type 1) 24-bit Sun raster of uint8 RGB: BGR rows padded
    to 16 bits."""
    import struct

    h, w, _ = rgb.shape
    stride = (w * 3 + 1) & ~1
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = rgb[..., ::-1].reshape(h, -1)
    return struct.pack(">8I", 0x59A66A95, w, h, 24, h * stride, 1, 0, 0) \
        + rows.tobytes()


# phase 25's misnamed files: (name in the CLI's folder, source folder,
# fixture): a WebP named .jpg, a TIFF named .png, an arithmetic-coded
# JPEG, a truncated progressive JPEG libjpeg smooths, a JP2, a run-length
# Radiance file, and a standard Sun raster of the run-length one's pixels
# (cv2 reads no run-length Sun raster)
MISNAMED = (("a.jpg", "WebP", "photo_768x512_lossy.webp"),
            ("b.png", "TIFF", "photo_768x512_jpeg_420.tif"),
            ("c.jpg", "JPEG", "arith_prog_768x512.jpg"),
            ("d.jpg", "JPEG", "truncated_smooth_768x512.jpg"),
            ("e.jpg", "JPEG2000", "photo_768x512_reversible.jp2"),
            ("f.jpg", "HDR", "photo_768x512_rle.hdr"),
            ("g.jpg", "SunRas", "photo_768x512_rle.ras"))


def misnamed_cli_check(tmp: str, want: dict) -> dict:
    """``python -m crdr_tpu_torch.cli.compress`` (run in this process, so
    its launches are counted) on the flagship, the device wire, over a
    folder of MISNAMED and, beside each, a PNG of its pixels (its file
    path's decode, held to cv2's digest): one batch of 14; each misnamed
    file's .bin byte-equal to its PNG's, the launches those of the JPEG
    body (``want``: K1 60, K2 11, E1 2, K3 0)."""
    import runpy

    import torch

    from crdr_tpu_torch.utils.img_utils import (decode_image, read_image,
                                                write_png)

    img_dir, out = os.path.join(tmp, "misnamed"), os.path.join(tmp, "out")
    os.makedirs(img_dir)
    for name, kind, fixture in MISNAMED:
        folder = JPEG_DIR if kind == "JPEG" else BODY_DIRS[kind]
        with open(os.path.join(folder, "digests.json")) as f:
            d = json.load(f)[fixture]
        path = os.path.join(img_dir, name)
        if kind == "SunRas":  # its pixels (PIL's digest) as a standard file
            with open(os.path.join(folder, fixture), "rb") as f:
                body = decode_image(f.read(), fixture, file_path=False)
            with open(path, "wb") as f:
                f.write(sun_raster(body))
        else:
            shutil.copy(os.path.join(folder, fixture), path)
        img = read_image(path)
        check(pixel_sha(img) == (d["body"] if kind == "SunRas" else
                                 d.get("cv2", d.get("file"))),
              f"{name} ({fixture}): read_image's pixels differ from cv2's")
        write_png(os.path.join(img_dir, f"twin_{name[0]}.png"), img)
    argv = [sys.argv[0], os.path.join(ROOT, "config", "crdr_throughput.yaml"),
            "--img_dir", img_dir,
            "--save_dir", out, "-q", "2.0", "-b", "2.56", "--decompress",
            "--batch", str(2 * len(MISNAMED)), "--wire", "device"]
    kernels = kernel_wrappers()
    for k in kernels.values():
        k.launches = 0
    saved = sys.argv
    sys.argv = argv
    t0 = time.perf_counter()
    try:
        runpy.run_module("crdr_tpu_torch.cli.compress", run_name="__main__",
                         alter_sys=True)
    finally:
        sys.argv = saved
    secs = time.perf_counter() - t0
    got = {n: k.launches for n, k in kernels.items()}
    gc.collect()
    torch.cuda.empty_cache()
    check(got == want, f"the misnamed files' CLI run: launches {got}, "
          f"expected {want} (a JPEG's)")
    equal = {}
    for name, _, fixture in MISNAMED:
        with open(os.path.join(out, f"{name[0]}.bin"), "rb") as f, \
                open(os.path.join(out, f"twin_{name[0]}.bin"), "rb") as g:
            equal[fixture] = f.read() == g.read()
        check(equal[fixture], f"{name} ({fixture}): its .bin differs from "
              "the .bin of its pixels' PNG")
    return {"files": [n for n, _, _ in MISNAMED], "launches": got,
            "bin_equal": equal, "cli_s": secs}


def png_decode_timing() -> dict:
    """The C++ PNG decoder on the card's host against its numpy twin, at
    768x512: PIL's optimized file of the photo and the file every row of
    which is Paeth (tests/data/png).  ms of the whole decode (chunks,
    Python's zlib, the pixels) and of the C++ pixels alone, medians of 12
    after 2 warm-up; the twin's whole decode, once; pixels equal."""
    from crdr_tpu_torch.utils import png

    res = {}
    for name in ("photo_768x512_pil.png", "photo_768x512_paeth.png"):
        with open(os.path.join(PNG_DIR, name), "rb") as f:
            data = f.read()
        parsed = png.parse_png(data, name)
        whole, pixels, plain = [], [], []
        for _ in range(14):
            t0 = time.perf_counter()
            img = png.decode_png(data, name)
            t1 = time.perf_counter()
            png.png_pixels(parsed, False, name)
            whole.append((t1 - t0) * 1e3)
            pixels.append((time.perf_counter() - t1) * 1e3)
        t0 = time.perf_counter()  # the numpy twin takes ~0.5 s a decode
        ref = png.decode_png_plain(data, name)
        plain.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(img, ref), f"{name}: the C++ decoder's pixels "
              "differ from its numpy twin's")
        res[name] = {"ms": float(np.median(whole[2:])),
                     "pixels_ms": float(np.median(pixels[2:])),
                     "plain_ms": float(np.median(plain)),
                     "rows_by_filter": np.bincount(np.frombuffer(
                         parsed.data, np.uint8)[::parsed.width * 3 + 1],
                         minlength=5).tolist()}
    return res


def jpeg_encode_check() -> dict:
    """The port's encoder on the card's host: the photo's pixels (the
    port's decode of photo_768x512.jpg) encoded, then that JPEG's decode
    (a reconstruction) encoded; each file's sha256 equal to the digest of
    cv2's bytes in digests.json (make_fixtures.py), its decode equal to
    cv2's decode of cv2's file; ms an encode at 768x512."""
    import hashlib

    from crdr_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    with open(os.path.join(JPEG_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(JPEG_DIR, "photo_768x512.jpg"), "rb") as f:
        pixels = decode_jpeg(f.read())
    res = {}
    for name in ("encoded_photo_q95.jpg", "encoded_reconstruction_q95.jpg"):
        data = encode_jpeg(pixels)
        sha = hashlib.sha256(data).hexdigest()
        check(sha == digests[name]["bytes"], f"encode_jpeg: {name}'s bytes "
              f"differ from cv2's (sha256 {sha})")
        pixels = decode_jpeg(data, name, file_path=True)
        check(pixel_sha(pixels) == digests[name]["file"],
              f"{name}: decoded pixels differ from cv2's")
        res[name] = sha
    runs = []
    for _ in range(12):
        t0 = time.perf_counter()
        encode_jpeg(pixels)
        runs.append((time.perf_counter() - t0) * 1e3)
    res["encode_ms_768x512"] = float(np.median(runs[2:]))
    return res


def jpeg_served_check(card: str) -> dict:
    """The 768x512 fixture as a request body to cli/serve.py's server
    (crdr_throughput.yaml, the device wire, E1): its .bin byte-equal to
    the .bin of a PNG of the same pixels; the JPEG body's round trip's
    launches those of phase 4, each kernel's calls held against its
    twin.  The 768x512 palette PNG (PIL's, tests/data/png) as a body too:
    its .bin byte-equal to the .bin of an RGB PNG of its pixels."""
    import torch

    from crdr_tpu_torch.serving.http_server import make_server
    from crdr_tpu_torch.utils.img_utils import (decode_image, decode_png,
                                                encode_png)
    from crdr_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    with open(os.path.join(JPEG_DIR, "photo_768x512.jpg"), "rb") as f:
        body = f.read()
    png = encode_png(decode_jpeg(body, "photo_768x512.jpg"))
    with open(os.path.join(PNG_DIR, "palette_768x512.png"), "rb") as f:
        pal = f.read()
    pal_rgb = encode_png(decode_image(pal, "palette_768x512.png",
                                      file_path=False))
    bodies = {}  # kind: (the body, the RGB PNG of its pixels)
    for kind, name in (("WebP", "photo_768x512_lossy.webp"),
                       ("GIF", "photo_768x512.gif")):
        with open(os.path.join(BODY_DIRS[kind], name), "rb") as f:
            data = f.read()
        bodies[kind] = (data, encode_png(decode_image(data, name,
                                                      file_path=False)))
    model, args = serve_model(card, wire="device")
    check(model.device_wire_encoder == "device",
          "the device wire's default encoder is E1")
    srv = make_server(model, port=0, max_batch=args.max_batch,
                      max_wait_s=args.max_wait_ms / 1e3)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    kernels = kernel_wrappers()
    try:
        http_post(base + "/decompress", http_post(
            base + "/compress?q=2.0", png)[0])  # warm: first calls
        with sampled_kernel_calls() as samples:
            for k in kernels.values():
                k.launches = 0
            blob, _, enc_s = http_post(base + "/compress?q=2.0", body)
            out, _, dec_s = http_post(base + "/decompress?beta=2.56", blob)
            got = {n: k.launches for n, k in kernels.items()}
        held = hold_served_kernels(samples, "JPEG body", card)
        blob_png = http_post(base + "/compress?q=2.0", png)[0]
        blob_pal = http_post(base + "/compress?q=2.0", pal)[0]
        blob_pal_rgb = http_post(base + "/compress?q=2.0", pal_rgb)[0]
        served = {}
        for kind, (data, rgb_png) in bodies.items():
            for k in kernels.values():
                k.launches = 0
            blob_k = http_post(base + "/compress?q=2.0", data)[0]
            http_post(base + "/decompress?beta=2.56", blob_k)
            launches_k = {n: k.launches for n, k in kernels.items()}
            served[kind] = {"launches": launches_k, "bin_bytes": len(blob_k),
                            "equal": blob_k == http_post(
                                base + "/compress?q=2.0", rgb_png)[0]}
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
    want = {"slice_transform": 6 * model.num_slices,
            "lane_decode_round": 1 + model.num_slices,
            "lane_encode_rounds": 2, "gdn": 0}
    check(got == want, f"JPEG body round trip: launches {got}, expected "
          f"{want} (phase 4's)")
    check(blob == blob_png, "the JPEG body's .bin != its PNG's")
    check(blob_pal == blob_pal_rgb, "the palette PNG body's .bin != the "
          "RGB PNG's of its pixels")
    for kind, sv in served.items():
        check(sv["equal"], f"the {kind} body's .bin != the RGB PNG's of its "
              "pixels")
        check(sv["launches"] == want, f"{kind} body round trip: launches "
              f"{sv['launches']}, expected {want} (the JPEG body's)")
    dec = decode_png(out)
    check(dec.shape == (IMG_H, IMG_W, 3),
          f"JPEG body: decoded {dec.shape}")
    # the reconstruction as JPEG, read back (no cv2 digest: its pixels are
    # the card's; its PSNR printed, not bounded: a random init's
    # reconstruction is noise-like, which JPEG keeps poorly)
    jpg = encode_jpeg(dec)
    back = decode_jpeg(jpg, "the served reconstruction")
    check(back.shape == dec.shape and encode_jpeg(dec) == jpg,
          f"the served reconstruction's JPEG: {back.shape}, or two encodes "
          "differ")
    mse = float(np.mean((back.astype(np.float64) - dec) ** 2))
    res = {"launches": got, "held": held, "bin_bytes": len(blob),
           "palette_bin_bytes": len(blob_pal), "bodies": served,
           "compress_ms": enc_s * 1e3, "decompress_ms": dec_s * 1e3,
           "recon_jpeg_psnr": 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def jpeg_training_check(card: str, tmp: str) -> dict:
    """3 steps of crdr_stage_1.yaml (OpenImageImageDataset, the recipe's
    model and losses, LPIPS's allow_random laid over it) on a train_0/ of
    the fixtures' JPEGs (repeat 2), on the card; the sample's and the
    loader's times."""
    import torch

    from crdr_tpu_torch.data import build_dataset
    from crdr_tpu_torch.trainer import build_trainer
    from crdr_tpu_torch.utils.img_utils import write_png

    with open(os.path.join(JPEG_DIR, "digests.json")) as f:
        names = [n for n, d in sorted(json.load(f).items())
                 if "raises" not in d and min(d["file_shape"][:2]) >= 2]
    train0 = os.path.join(tmp, "openimage", "train_0")
    kodak = os.path.join(tmp, "kodak")
    os.makedirs(train0)
    os.makedirs(kodak)
    for n in names:
        shutil.copy(os.path.join(JPEG_DIR, n), train0)
    write_png(os.path.join(kodak, "kodim01.png"),
              np.full((64, 96, 3), 128, np.uint8))
    # train -wb: loss, validation and time logged at the last step
    cfg = train_config("crdr_stage_1.yaml", tmp, "jpeg",
                       total_iter=JPEG_STEPS, log_step=JPEG_STEPS,
                       eval_step=JPEG_STEPS, time_step=JPEG_STEPS,
                       use_wandb=True, wandb_loss_step=JPEG_STEPS)
    check(cfg.dataset.train_dataset.name == "openimage",
          "crdr_stage_1.yaml's dataset is no longer OpenImage")
    # repeat 2: an epoch of 5 batches, so the 3 steps' waits hold no
    # epoch restart
    cfg.dataset.train_dataset.update(root_dir=os.path.dirname(train0),
                                     subset_list=[0], seed=0, repeat=2)
    cfg.dataset.eval_dataset.update(root_dir=kodak)
    cfg.loss.perceptual_loss.update(allow_random=True)
    ds = build_dataset(cfg.dataset.train_dataset, is_train=True)
    check(type(ds).__name__ == "OpenImageImageDataset" and
          len(ds) == 2 * len(names), f"the JPEG tree: {type(ds).__name__} "
          f"of {len(ds)}")
    runs = []
    for i in range(len(names)):
        t0 = time.perf_counter()
        ds[i]
        runs.append((time.perf_counter() - t0) * 1e3)
    with without_wandb():  # -wb's JSONL stream, never wandb.init
        tr = build_trainer(cfg, CARD)
    loader = TimedLoader(tr.train_loader)
    tr.train_loader = loader
    logs, steps, _ = record_steps(tr)
    t0 = time.perf_counter()
    tr.train_loop()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(len(logs) == JPEG_STEPS, f"JPEG training: {len(logs)} steps "
          f"({JPEG_STEPS} expected)")
    last = check_logs(logs, "JPEG training")
    batch = next(iter(tr.train_loader.loader))["real_images"]
    check(batch.shape == (8, 256, 256, 3) and np.isfinite(batch).all(),
          f"JPEG training batch {batch.dtype} {batch.shape}")
    wandb = wandb_stream_check(cfg, last)
    saved = validation_jpeg_check(tr, os.path.join(tmp, "samples"))
    res = {"sources": len(names), "sample_ms": float(np.median(runs)),
           "steps": len(logs), "step_ms": float(np.median(steps[1:])),
           "wait_ms": float(np.mean(loader.waits[1:])),
           "wait_max_ms": float(np.max(loader.waits[1:])),
           "first_wait_ms": loader.waits[0], "run_s": secs,
           "loss_last": last["total"], "wandb": wandb,
           "validation_samples": saved}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def without_wandb():
    """``import wandb`` fails within the block.  The card's host has wandb
    installed but no login, and ``wandb.init`` would need one and the
    network; so ``use_wandb`` takes the JSONL stream of
    ``utils/wandb_compat.py``, as where wandb is not installed."""
    saved = sys.modules.get("wandb")
    sys.modules["wandb"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved


# JAX's Timer.get_time_stat keys (tests/test_torch_trainer.py holds the
# port's to them)
TIME_STAT_KEYS = {"sec_per_iter", "iter_per_sec", "elapsed_hours",
                  "eta_hours"}


def wandb_stream_check(cfg, last: dict) -> dict:
    """The -wb run's JSONL (wandb is not installed on the card's host):
    at the last step a loss line (the step's loss keys), an eval_* line and
    a time line, each with "iter" and "_ts", JAX's keys."""
    path = os.path.join(cfg.path.job_dir, f"wandb_{cfg.exp}.jsonl")
    check(os.path.exists(path), f"train -wb wrote no {path}")
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    keys = [set(x) - {"_ts", "iter"} for x in lines]
    want = [set(last) - {"skipped"}, None, TIME_STAT_KEYS]
    check(len(lines) == 3 and all("_ts" in x and x["iter"] == JPEG_STEPS
                                  for x in lines)
          and keys[0] == want[0] and keys[2] == want[2]
          and {"eval_bpp", "eval_psnr", "eval_ms_ssim"} <= keys[1]
          and all(k.startswith("eval_") for k in keys[1]),
          f"train -wb's JSONL: {[sorted(k) for k in keys]}")
    return {"lines": len(lines), "keys": [sorted(k) for k in keys]}


def validation_jpeg_check(tr, save_dir: str) -> list:
    """validation(save_img=True) on the trained model: JAX's .jpg names,
    each file read back by the port's decoder at the eval image's shape."""
    from crdr_tpu_torch.utils.img_utils import read_image

    model = tr.comp_model
    rows = model.validation(tr.eval_loader, max_sample_size=1,
                            save_img=True, save_dir=save_dir)
    qs = [f"_q{q}" for q in range(model.rate_level)] if model.use_rate \
        else [""]
    want = sorted([f"sample_1_fake{q}.jpg" for q in qs]
                  + ["sample_1_real.jpg"])
    saved = sorted(os.listdir(save_dir))
    check(saved == want, f"validation(save_img=True) wrote {saved}, JAX "
                         f"writes {want}")
    shapes = {read_image(os.path.join(save_dir, n)).shape for n in saved}
    check(len(rows) == 1 and len(shapes) == 1,
          f"validation samples: {len(rows)} rows, shapes {shapes}")
    return saved


def jpeg_phase(card: str) -> tuple:
    """Phase 25: JPEG input (module doc); returns ({figures}, {path:
    launches})."""
    import tempfile

    from crdr_tpu_torch.utils.jpeg import decode_jpeg

    from crdr_tpu_torch.utils.png import decode_png_plain

    t_phase = time.perf_counter()
    res = {"fixtures": fixtures_check(JPEG_DIR), "cpu_count": os.cpu_count(),
           "png_fixtures": fixtures_check(PNG_DIR, decode_png_plain),
           "bmp_fixtures": fixtures_check(BMP_DIR),
           "png_decode": png_decode_timing()}
    with open(os.path.join(JPEG_DIR, "photo_768x512.jpg"), "rb") as f:
        data = f.read()
    runs = []
    for _ in range(22):
        t0 = time.perf_counter()
        decode_jpeg(data)
        runs.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(runs[2:]))
    res.update(decode_ms_768x512=ms, decode_ms_per_mpix=ms / 0.393216)
    # after the JPEG timing, which read ~40% slower when these ran first
    res["body_fixtures"] = {k: body_fixtures_check(k) for k in BODY_DIRS}
    res["body_decode"] = body_decode_timing()
    res["encoder"] = jpeg_encode_check()
    res["new_formats_decode"] = decode_timing_768x512()
    res["new_readers_decode"] = new_readers_timing()
    res["served"] = jpeg_served_check(card)
    with tempfile.TemporaryDirectory() as tmp:
        res["truncated_dataset"] = truncated_dataset_check(tmp)
        res["misnamed_cli"] = misnamed_cli_check(tmp,
                                                 res["served"]["launches"])
        res["training"] = jpeg_training_check(card, tmp)
    res["phase_s"] = time.perf_counter() - t_phase
    fx, sv, tr = res["fixtures"], res["served"], res["training"]
    print(f"JPEG input: {fx['decoded']} fixtures' pixels equal to cv2's and "
          f"PIL's digests on both paths, {fx['refused']} refused with their "
          f"reasons; the decoder {ms:.2f} ms at 768x512 "
          f"({res['decode_ms_per_mpix']:.2f} ms a Mpix, one host thread; "
          f"os.cpu_count() {res['cpu_count']}); a served JPEG body's .bin "
          f"equal to its PNG's, launches {sv['launches']}; "
          f"{tr['steps']} steps of crdr_stage_1.yaml on "
          f"{tr['sources']} JPEGs (OpenImageImageDataset): a sample "
          f"{tr['sample_ms']:.2f} ms, median step {tr['step_ms']:.1f} ms, "
          f"the loader's wait {tr['wait_ms']:.2f} ms a step (max "
          f"{tr['wait_max_ms']:.2f}, first {tr['first_wait_ms']:.1f}); last "
          f"total loss {tr['loss_last']:.4f}; "
          f"phase {res['phase_s']:.1f} s [{card}]")
    bfx, bd, bodies = res["body_fixtures"], res["body_decode"], sv["bodies"]
    print(f"Truncated JPEGs: {fx['truncated']} read on the file path as "
          f"cv2 reads them ({res['truncated_dataset']['files']} through "
          f"OpenImageImageDataset too), refused on the body path as PIL "
          f"refuses them.  Request bodies as PIL reads them: "
          + ", ".join(f"{k} {v['decoded']['body']} fixtures equal to PIL's "
                      f"digests ({v['refused']['body']} refused with their "
                      "reasons)" for k, v in bfx.items())
          + "; at 768x512 (synthetic_images) "
          f"the WebP decoder {bd['webp_lossy']['ms']:.2f} ms lossy / "
          f"{bd['webp_lossless']['ms']:.2f} ms lossless (equal to the "
          f"pixels), the GIF reader {bd['gif']['ms']:.2f} ms (one host "
          f"thread); served bodies: "
          + ", ".join(f"{k} .bin equal to its pixels' PNG's, launches "
                      f"{v['launches']}" for k, v in bodies.items())
          + f"; phase {res['phase_s']:.1f} s [{card}]")
    pf, bf, pd = res["png_fixtures"], res["bmp_fixtures"], res["png_decode"]
    print(f"PNG and BMP input: {pf['decoded']} PNG fixtures' pixels equal "
          f"to cv2's and PIL's digests on both paths ({pf['twin_checked']} "
          f"decodes equal to the numpy twin's), {pf['refused']} refused with "
          f"their reasons; {bf['decoded']} BMP fixtures likewise; the C++ "
          f"PNG decoder at 768x512, whole decode / its pixels / numpy twin: "
          + "; ".join(f"{n} (rows by filter {v['rows_by_filter']}) "
                      f"{v['ms']:.2f} / {v['pixels_ms']:.2f} / "
                      f"{v['plain_ms']:.1f} ms" for n, v in pd.items())
          + f" (one host thread); a served palette PNG body's .bin equal to "
          f"the RGB PNG's of its pixels [{card}]")
    en = res["encoder"]
    print(f"JPEG output: encode_jpeg of the photo's pixels and of their "
          f"JPEG's decode byte-equal to cv2's (sha256 "
          f"{en['encoded_photo_q95.jpg'][:16]}..., "
          f"{en['encoded_reconstruction_q95.jpg'][:16]}...); "
          f"{en['encode_ms_768x512']:.2f} ms an encode at 768x512 (one host "
          f"thread); the served reconstruction's JPEG "
          f"{sv['recon_jpeg_psnr']:.2f} dB; validation(save_img=True) wrote "
          f"{tr['validation_samples']}; train -wb's JSONL: "
          f"{tr['wandb']['lines']} lines with JAX's keys [{card}]")
    mc, nd = res["misnamed_cli"], res["new_formats_decode"]
    print(f"Files read by their bytes as cv2.imread reads them: "
          + ", ".join(f"{k} {v['decoded']['file']} fixtures equal to cv2's "
                      f"digests on the file path ({v['refused']['file']} "
                      f"refused where cv2 returns None or by name)"
                      for k, v in bfx.items())
          + f"; the compress CLI over {', '.join(mc['files'])} (a WebP, a "
          f"TIFF, an arithmetic JPEG, a smoothed truncated progressive "
          f"JPEG, a JP2, a Radiance file and a Sun raster) and their "
          f"pixels' PNGs, one batch of {2 * len(MISNAMED)} on the device "
          f"wire: each .bin equal to its PNG's, launches {mc['launches']} "
          f"({mc['cli_s']:.1f} s, model build included); decode ms at "
          f"768x512 (one host thread): "
          + ", ".join(f"{k} {v['ms']:.2f}" for k, v in nd.items())
          + f" [{card}]")
    nr = res["new_readers_decode"]
    print("JPEG 2000, Sun raster and Radiance HDR input: "
          + ", ".join(f"{k} {bfx[k]['decoded']['file']} fixtures equal to "
                      f"cv2's digests on the file path and "
                      f"{bfx[k]['decoded']['body']} to PIL's on the body "
                      f"path ({bfx[k]['refused']['file']} / "
                      f"{bfx[k]['refused']['body']} refused with their "
                      "reasons)" for k in ("JPEG2000", "SunRas", "HDR"))
          + "; decode ms at 768x512 (one host thread): "
          + ", ".join(f"{k} {v['ms']:.2f}" for k, v in nr.items())
          + f" [{card}]")
    return res, {"jpeg body": sv["launches"],
                 **{f"{k.lower()} body": v["launches"]
                    for k, v in sv["bodies"].items()},
                 "misnamed files (compress CLI)": mc["launches"]}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA GPU: the port's smoke run needs one")
    if not os.path.isdir(os.path.join(ROOT, "crdr_tpu_torch")):
        fail("crdr_tpu_torch/ not found: run from the root of a checkout")
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    profiling = "--profile" in sys.argv[1:]

    card = card_line()
    print(f"card: {card}")
    ptxas = timed("build", build_kernels)
    k1 = timed("k1", k1_phase, card)
    timed("k1 split", k1_split_phase, card)
    model = timed("flagship build", build_model, card)
    imgs = smooth_images(7)
    if "--ab-encode" in sys.argv[1:]:
        encode_ab_phase(model, imgs, card)
    encs_c, counts_c, times_c = timed(
        "compressai wire", host_wire_path, model, imgs, "compressai wire",
        {"slice_transform": 6 * model.num_slices,  # 3 a slice, each way
         "lane_decode_round": 0, "gdn": 0}, card)
    if profiling:
        profile_phase(lambda: model.compress_batch(imgs, rate_ind=RATE),
                      f"compressai encode batch {N_IMG}", card, ("k1_",))
        profile_phase(lambda: model.decompress_batch(
            [e["string_list"] for e in encs_c], beta=BETA),
            f"compressai decode batch {N_IMG}", card, ("k1_",))
    y_c = np.concatenate([e["y_hat"] for e in encs_c])
    recorded, counts_d, times_d, encs_d = timed(
        "device wire", device_wire_path, model, imgs, y_c, card)
    host_streams = [e["string_list"] for e in encs_d]  # for phase 11
    if profiling:
        encs_d = model.compress_batch(imgs, rate_ind=RATE)
        profile_phase(lambda: model.decompress_batch(
            [e["string_list"] for e in encs_d], beta=BETA),
            f"device-wire decode batch {N_IMG}", card,
            ("k1_", "lane_decode_round_kernel"))
    k2 = timed("k2", k2_phase, recorded, 1 + model.num_slices, card,
               ptxas["lane_decode"])
    _, counts_actv = timed("slice actv", slice_actv_check, model, imgs, y_c,
                           card)
    print(f"both wires, batch {N_IMG}, medians: compressai encode "
          f"{times_c['encode_ms']:.1f} / decode {times_c['decode_ms']:.1f} ms; "
          f"device encode {times_d['encode_ms']:.1f} / decode "
          f"{times_d['decode_ms']:.1f} ms [{card}]")
    del model, recorded
    torch.cuda.empty_cache()

    k3 = timed("k3", k3_phase, card, ptxas["gdn"])
    gdn_model = timed("GDN build", build_gdn_model, imgs, card)
    encs_g, counts_g, _ = timed(
        "GDN path", host_wire_path, gdn_model, imgs,
        "GDN path",  # 3 GDN in the analysis, 3 IGDN after
        {"slice_transform": 0, "lane_decode_round": 0, "gdn": 6}, card)
    deconv = timed("deconv", deconv_phase, gdn_model, card)
    if profiling:  # the f32 compressai-wire path, before the bf16 half
        profile_phase(lambda: gdn_model.compress_batch(imgs),
                      f"GDN path encode batch {N_IMG}", card,
                      ("gdn_kernel",))
        profile_phase(lambda: gdn_model.decompress_batch(
            [e["string_list"] for e in encs_g]),
            f"GDN path decode batch {N_IMG}", card, ("gdn_kernel",))
    # leaves gdn_model at bf16 on the device wire
    gdn_bf16 = timed("GDN bf16", gdn_bf16_phase, gdn_model, imgs, encs_g,
                     card)

    del gdn_model
    torch.cuda.empty_cache()

    counts_m, _ = timed("model classes", model_class_phase, imgs, card)
    counts_t, _ = timed("tf32 chain", tf32_chain_phase, imgs, card)
    counts_e = timed("entry points", entry_point_phase, imgs, card)
    rec_e1, esc_e1, cap_e1, st_e1, counts_f, med_f = timed(
        "device encoder", flagship_device_encoder_phase, imgs,
        host_streams, card)
    e1 = timed("e1", e1_phase, rec_e1, esc_e1, cap_e1, st_e1, card,
               ptxas["lane_encode"])
    del rec_e1, esc_e1
    counts_cb, _ = timed("checkerboard", checkerboard_phase, imgs, card,
                         profiling)
    counts_gw, _, long_k2 = timed("generic device wire",
                                  generic_device_phase, imgs, card)
    train, counts_tr = timed("training", training_phase, card, profiling)
    timed("cross-device", cross_device_phase,
          np.ascontiguousarray(imgs[:1, :CROSS_H, :CROSS_W]), card)
    serving, counts_sv = timed("serving", serving_phase, card)
    evaluation, counts_ev, pending = timed("evaluation", eval_phase, card)
    counts_fam, _ = timed("families", family_phase, imgs, card, profiling)
    evaluation["metrics"].update(timed("metrics' processes", metrics_end,
                                       pending, card))
    resize = timed("resize_range", resize_phase, card)
    data_parallel, counts_dp = timed("data parallel", dp_phase, card)
    serving_mesh, counts_mesh = timed("serving mesh", mesh_phase, imgs, card)
    aot, counts_aot = timed("aot", aot_phase, imgs, card)
    jpeg_input, counts_jpeg = timed("jpeg", jpeg_phase, card)

    print("training " + json.dumps(train))
    print("serving " + json.dumps(serving))
    print("evaluation " + json.dumps(evaluation))
    print("resize_range " + json.dumps(resize))
    print("data_parallel " + json.dumps(data_parallel))
    print("serving_mesh " + json.dumps(serving_mesh))
    print("aot " + json.dumps(aot))
    print("jpeg_input " + json.dumps(jpeg_input))
    print("phase_seconds " + json.dumps(PHASE_S))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    r = k1["by_cin"][480]
    k3r, k3b = k3["rows"], k3["bf16_rows"]
    launches = {"compressai": counts_c, "device": counts_d, "gdn": counts_g,
                **{f"GDN path bf16 {w}": gdn_bf16[w]["launches"]
                   for w in ("compressai", "device")},
                **counts_m, **counts_t, **counts_e,
                "flagship device encoder": counts_f, **counts_cb,
                **counts_gw, **counts_tr, **counts_sv, **counts_ev,
                **counts_fam, **counts_dp, **counts_mesh, **counts_aot,
                **counts_jpeg, **counts_actv}
    print(json.dumps({"kernels": [{
        "name": "slice_transform", "route": "cuda",
        "source": "crdr_tpu_torch/csrc/slice_transform.cu",
        "replaces": "crdr_tpu/ops/pallas_slice_transform.py:75",
        "launches": counts_d["slice_transform"],
        "launches_by_path": {p: c.get("slice_transform", 0)
                             for p, c in launches.items()},
        "max_abs_err": max(x["max_abs_err"] for x in k1["by_cin"].values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "ms_batch1": r["ms_batch1"], "eager_ms": r["eager_ms"],
        "ms_by_stage": r["ms_by_stage"],
        "ms_by_stage_batch1": r["ms_by_stage_batch1"],
        "hgmma": k1["sass"]["HGMMA"], "hmma": k1["sass"]["HMMA"],
        "ms_cin512": k1["by_cin"][512]["ms"],
        "library_ms_cin512": k1["by_cin"][512]["library_ms"],
        "shape": f"N{N_IMG} {IMG_H // 16}x{IMG_W // 16} Cin 480->224->128->32",
        "card": card}, {
        "name": "lane_decode_round", "route": "cuda",
        "source": "crdr_tpu_torch/csrc/lane_decode.cu",
        "replaces": "crdr_tpu/ops/pallas_lane_decode.py:116",
        "launches": counts_d["lane_decode_round"],
        "launches_by_path": {p: c.get("lane_decode_round", 0)
                             for p, c in launches.items()},
        "long_round": long_k2,
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None,
        **{key: k2[key] for key in (
            "eager_ms", "z_ms", "z_eager_ms", "prologue_ms", "prologue_z_ms",
            "global_table_ms", "cycles_per_step", "cycles_per_step_z",
            "cycles_clock_mhz", "cycles_clock", "registers", "spill_bytes",
            "smem_bytes", "smem_bytes_z", "shape")},
        "card": card}, {
        "name": "gdn", "route": "cuda",
        "source": "crdr_tpu_torch/csrc/gdn.cu",
        "replaces": "crdr_tpu/ops/pallas_gdn.py:37",
        "launches": counts_g["gdn"],
        "launches_by_path": {p: c.get("gdn", 0)
                             for p, c in launches.items()},
        "max_abs_err": max(x["max_abs_err"] for x in k3r),
        "max_rel_err": max(x["max_rel_err"] for x in k3r),
        "differing": sum(x["differing"] for x in k3r),
        "ms": k3r[0]["ms"],
        "eager_ms": k3r[0]["eager_ms"], "plain_ms": k3r[0]["plain_ms"],
        "bound_ms": k3r[0]["bound_ms"], "bound_by": k3r[0]["bound_by"],
        "library_ms": k3r[0]["library_ms"],
        "transpose_ms": k3r[0]["transpose_ms"],
        "registers": k3["registers"], "spill_bytes": k3["spill_bytes"],
        "blocks_per_sm": k3["blocks_per_sm"],
        "tile_pixels": k3["tile_pixels"],
        "ms_by_call": {f"{x['shape']} {'igdn' if x['inverse'] else 'gdn'}":
                       x["ms"] for x in k3r},
        "eager_ms_by_call": {
            f"{x['shape']} {'igdn' if x['inverse'] else 'gdn'}":
            x["eager_ms"] for x in k3r},
        "bound_ms_by_call": {
            f"{x['shape']} {'igdn' if x['inverse'] else 'gdn'}":
            x["bound_ms"] for x in k3r},
        "library_ms_by_shape": {str(x["shape"]): x["library_ms"]
                                for x in k3r},
        "shape": f"{list(GDN_SHAPES[0])} NCHW f32 (ms: CUDA-graph replay, "
                 "gamma^T copy included; bound, plain, library); all six "
                 "path calls in ms_by_call",
        "deconv_yardstick": deconv,
        "training_gdn_step": {"launches_per_step":
                              counts_tr["train gdn"]["gdn"] // SHORT_STEPS,
                              **train["gdn"]["k3"]},
        "card": card}, {
        "name": "gdn_bf16", "route": "cuda",
        "source": "crdr_tpu_torch/csrc/gdn.cu",
        "replaces": "crdr_tpu/ops/pallas_gdn.py:37 (its bf16 use: JAX's "
                    "bf16 GDN is the einsum path of crdr_tpu/nn/norm.py:63, "
                    "the Pallas body cannot store bf16)",
        "launches": gdn_bf16["compressai"]["launches"]["gdn"],
        "launches_by_path": {p: c.get("gdn", 0) for p, c in launches.items()
                             if "bf16" in p},
        "max_abs_err": max(x["max_abs_err"] for x in k3b),
        "max_ulps": max(x["ulps"] for x in k3b),
        "differing": sum(x["differing"] for x in k3b),
        "ms": k3b[0]["ms"], "eager_ms": k3b[0]["eager_ms"],
        "plain_ms": k3b[0]["plain_ms"], "bound_ms": k3b[0]["bound_ms"],
        "bound_by": k3b[0]["bound_by"], "library_ms": k3b[0]["library_ms"],
        "f32_ms": k3r[0]["ms"],
        "registers": k3["registers_bf16"],
        "blocks_per_sm": k3["blocks_per_sm_bf16"],
        "tile_pixels": k3["tile_pixels_bf16"],
        "smem_bytes": k3["smem_bytes_bf16"],
        "hmma": k3["sass_bf16"]["HMMA"], "hgmma": k3["sass_bf16"]["HGMMA"],
        "ms_by_call": {f"{x['shape']} {'igdn' if x['inverse'] else 'gdn'}":
                       x["ms"] for x in k3b},
        "bound_ms_by_call": {
            f"{x['shape']} {'igdn' if x['inverse'] else 'gdn'}":
            x["bound_ms"] for x in k3b},
        "psnr": {"f32": gdn_bf16["f32_psnr"],
                 **{f"bf16 {w}": gdn_bf16[w]["psnr"]
                    for w in ("compressai", "device")}},
        "shape": f"{list(GDN_SHAPES[0])} NCHW bf16 (ms: CUDA-graph replay, "
                 "gamma as it lies, no copy; library: cuBLAS's bf16 product "
                 "gamma . x^2)",
        "card": card}, {
        "name": "lane_encode_rounds", "route": "cuda",
        "source": "crdr_tpu_torch/csrc/lane_encode.cu",
        "replaces": "crdr_tpu/ops/device_rans.py:243 (lane_encode_rounds, a "
                    "lax.scan: a port-only kernel, no Pallas kernel)",
        "launches": counts_f["lane_encode_rounds"],
        "launches_by_path": {p: c.get("lane_encode_rounds", 0)
                             for p, c in launches.items()},
        "max_abs_err": e1["max_abs_err"], "ms": e1["ms"],
        "plain_ms": e1["plain_ms"], "bound_ms": e1["bound_ms"],
        "bound_by": e1["bound_by"], "library_ms": None,
        **{key: e1[key] for key in (
            "eager_ms", "call_ms", "call_eager_ms", "fixups_ms", "z_ms",
            "z_call_ms", "host_ms", "host_z_ms", "cycles_per_step",
            "cycles_clock_mhz", "registers", "spill_bytes", "shape")},
        "encode_ms_device_vs_host": med_f,
        "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
