"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printed before the last line:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the CUDA kernels from their two sources in the checkout (the
   forward's and the backward's), an nvcc each, started together;
3. kernels: each kernel against its plain PyTorch version at every shape
   the base codec gives it for a 524288-sample transfer and for one
   streamed buffer (the crossfade windows of 16384 samples), with times of
   the kernel, the plain version and one library call, the least time the
   card could take for the work (H100 SXM data sheet: 495 TFLOP/s TF32 on
   the tensor cores, three TF32 products per multiply-add in 3xTF32,
   3.35 TB/s; the bound on the f32 CUDA cores, 67 TFLOP/s, printed beside
   it), the kernel's TFLOP/s and share of its bound, and its error against a
   float64 plain version beside those of strict-f32 and TF32 F.conv1d (at
   most 2048 frames a shape; the kernel may be at most 4x strict F.conv1d);
   then the kernel's split sum (``sum_splits``) alone at every split shape
   of the path: equal bits to its plain version (the same adds in the same
   order), its time beside the plain version's, ``torch.sum(ws, dim=0)``'s
   and its byte bound ((splits + 1) x B x T x O x 4 bytes at 3.35 TB/s),
   each timed over inputs rotated through more memory than the L2 cache
   holds (ROTATE_BYTES), so that they come from HBM; a time below the
   bound fails;
4. serving: the base config at full width, port-native random weights from
   a fixed seed, answering 3 transfer requests of 524288 samples (batch 1,
   20 Euler steps, guidance_timbre 2.0) through ``TransferPipeline``'s
   default, one CUDA graph a transfer: the first request warms up and
   captures it (the wrapper's calls and ConvBlock1d shapes checked there),
   then the 3 requests replay it (the kernel counting its 96 launches a
   replay on the device, with the counts set to 0 just before the 3 and
   read just after), then the same requests op by op (``eager``):
   medians of both, their outputs within GRAPH_TOL; per-phase times as
   graphs and op by op; the graph pool's memory and capture time; one
   more transfer of each kind under torch.profiler: device busy time, idle
   share, launches (96 ``snake_conv_3xtf32`` in one replay and the split
   sum's ``sum_splits`` launches, counted by the profiler and held to the
   device's counts, with their device ms), the kernels that
   took the most device time, and a check that no TF32 kernel ran but the
   port's own 3xTF32 kernel; one transfer op by op with host syncs
   refused (``set_sync_debug_mode("error")``);
5. card vs CPU: the same port and weights on a 65536-sample clip, 4 steps,
   fixed x0, the card's output (kernels, through its CUDA graph) against
   the CPU's (plain versions); the same comparison with TF32 allowed is
   printed beside it, as the reading that the limit must stay below;
6. streaming: the same weights through ``Streamer(chunk_size=4,
   n_fade=4)`` (the crossfade path, the kernel on every conv window), batch
   1, guidance_timbre 2.0, as CUDA graphs (its default: a graph each for
   structure, timbre, the Euler step of each KV slot and decode, captured
   by ``init_state``; its captures checked as in phase 4) and op by op
   (``eager=True``) with the same noise: 2 warm-up buffers, then phase 4's
   first request as 64 buffers of 8192 samples (185.76 ms of audio each)
   at nb_steps 1 and at 4, each buffer timed on the host clock around
   ``forward`` ending in a synchronize (median, p90, max, real-time
   factor), 96 kernel launches a buffer counted on the device (counts set
   to 0 just before each run of 64 buffers and read just after), each
   output finite and of shape
   (1, 8192, 1), the state's tensors at fixed addresses, graph and eager
   within GRAPH_TOL over the 64 buffers; then 64 buffers with nb_steps
   cycling through 1-16 and both guidances changing every buffer: no
   capture after ``init_state``, graph and eager within GRAPH_TOL; one more
   buffer of each kind under torch.profiler as in phase 4, one op by op
   with host syncs refused; the graph pool's memory and capture time;
7. streaming card vs CPU: STREAM_VS_CPU_BUFFERS buffers of two voices
   with fixed x0, the card
   through its graphs against the CPU within phase 5's limit (the TF32
   reading beside it), for the base config and for the causal, norm-free
   ``get_config("base", "streaming")`` with port-native weights, which
   streams through cached convs and launches no kernel.

8. codec training: ``AutoencoderTrainer`` with the base codec
   (``get_ae_config()``), the default discriminator (6 scales, 64 filters)
   and ``AETrainConfig()`` at its defaults (batch 8 x 131072 samples, 7
   MR-STFT scales with A-weighting) but ``warmup_steps=2``, port-native
   weights from the seed, 10 steps of ``fit`` on synthetic audio (a few
   sinusoids plus noise, made on the card from the seed): 3 warm-up
   generator steps, GAN generator steps 3, 5, 6, 7 and 9, discriminator
   steps 4 and 8; each step's host time ending in a synchronize and the
   median of each kind without its first step; every metric finite, no
   skipped update, the codec's parameters changed by each generator step
   and the discriminator's by each discriminator step, 64 kernel launches
   a step (one codec forward), and in each generator step 64 launches of
   each backward kernel (dgrad and wgrad) and of their sums of partials as
   their plans ask, none in a discriminator step, counted on the device
   (the counts set to 0 before ``fit`` and after each step's callback);
   one more GAN generator step under torch.profiler as in phase 4 (no TF32
   kernel but the port's own); peak device memory; the cost of weight norm
   and of the kernel's weight split per codec forward; then the kernel at
   every shape of a training codec forward (batch 8), as in phase 3, and
   the op's backward kernels at the same shapes (``check_gradients``):
   gradients through autograd against plain autograd (GRAD_TOL), the op
   against its plain backward tensor by tensor (KERNEL_TOL), against
   float64 within F64_RATIO of the strict-f32 plain backward, the same
   bits from two launches and from a CUDA graph replay, and per generator
   step from CUDA graphs the backward's time (and eager), dgrad's and
   wgrad's each beside the plain backward's and ``F.conv1d``'s autograd
   backward for the same gradients, and the whole of ``F.conv1d``'s, each
   with cudnn.benchmark off and on, and the bound on the 3xTF32 tensor cores
   beside the plain VJP's on the f32 CUDA cores;
9. training card vs CPU: the same weights at batch 1 and 16384 samples,
   fixed bottleneck noise, one GAN generator step's and one discriminator
   step's losses (within CARD_VS_CPU_TOL) and gradients (each tensor within
   TRAIN_GRAD_TOL of its model x the larger of its max |g| and 1e-3 x the
   model's largest gradient, the median over tensors within
   TRAIN_GRAD_MEDIAN_TOL), with the reading with TF32 allowed beside them;
10. diffusion training: ``DiffusionTrainer`` with ``get_config("base",
   "cycle")`` resolved to ``in_size=64, n_signal=128`` at batch 32 (every
   dropout on), port-native weights from the seed, the curriculum cut so
   that 15 steps of ``fit`` run every kind (DIFF_SCHEDULE: phase-1 steps
   0-2, phase-2 diffusion steps 3 and 6, cycle steps 9 and 12 with the
   timbre encoder frozen from step 10, classifier steps between them); the
   first DIFF_COLLATE_STEPS batches from the port's collate over synthetic
   (64, 4096) latent records made from the seed, the rest from a
   ``DeviceLatentBank`` of the same records on the card.  The 15 steps run
   as CUDA graphs, the trainer's default: each step's host time ending in
   a synchronize; every metric finite, no skipped update, each diffusion
   step moving the denoiser, each encoder only while it trains (the frozen
   timbre encoder's BatchNorm statistics still moving), the classifier
   only in classifier steps and the EMA only in diffusion steps; one
   capture at the first step of each step signature and none after (at
   most DIFF_MAX_GRAPHS); the graph pool's memory and peak device memory.
   The same 15 steps op by op (``eager=True``) from the same weights,
   generator seed and batches: per-step metrics within DIFF_GRAPH_TOL and
   final parameters within DIFF_GRAPH_LR_TOL x lr an update of the graphs'
   (the readings printed beside the limits; the parameters' limit is a
   reading only), and the same pair with cuDNN's deterministic algorithms
   held to the same bits, which is the check; one op-by-op
   diffusion, cycle and classifier step each under
   ``set_sync_debug_mode("error")``.  The
   same schedule with ``steps_per_call=3`` as graphs: callbacks at
   DIFF_WINDOW_STEPS, each window's metrics within DIFF_GRAPH_TOL of the
   single steps' means, each window's ms.  A longer schedule
   (DIFF_LONG_SCHEDULE, DIFF_LONG_STEPS steps: at least 10 of each
   phase-2 kind, all 5 signatures) as graphs and op by op: the median of
   each kind without the first step of each signature, peak memory; then
   as windows of 3 steps: the median of the windows that capture nothing;
   one replayed step of each phase-2 kind (diffusion, cycle, classifier)
   under torch.profiler as in phase 4 (launches, busy time, idle share); a
   checkpoint saved and restored under build/ with equal tensors;
   ``validate``, then ``val_transfer_margin`` with the base codec of phase
   4 through ``make_codec_coder`` (20 steps; its round trip decodes and
   encodes 16 rows of 128 frames), the kernel's launches in it counted and
   each launch held to its plain version, its time at those shapes as in
   phase 3;
11. diffusion training card vs CPU: the same base weights at batch 4, every
   dropout 0, fixed draws: one cycle diffusion step's and one classifier
   step's metrics (within CARD_VS_CPU_TOL) and gradients (each tensor
   within DIFF_GRAD_TOL x the larger of its max |g| and 1e-3 x its model's
   largest gradient, the median over each model's tensors within
   DIFF_GRAD_MEDIAN_TOL), the reading with TF32 allowed beside them;
12. training from the command line (``after_tpu_torch.cli.main.main``, in
   this process, tensorboard kept out): a waveform store of CLI_RECORDS
   records of about 3 s of synthetic audio from the seed, int16 as
   prepare_dataset stores them, written with the port's ``RecordWriter``;
   ``train_autoencoder`` with the base codec at batch 8 x 131072,
   ``warmup_steps`` TRAIN_WARMUP, CLI_AE_STEPS steps, checkpoints and
   validation every CLI_AE_EVERY, then ``--restart`` for 2 more steps,
   which must resume at step CLI_AE_STEPS with the saved weights,
   optimizer states and step, every kernel launch of the restart held to
   its plain version (the timed run's launches are counted only); a
   latent store of DIFF_RECORDS records with the trained codec's latent
   channels; ``train`` with phase 10's config, batch and longer schedule
   (``--override``) for CLI_DIFF_STEPS steps, validated at the end through
   the codec run (``--emb_model_path``: its round trip and audio decodes,
   every kernel launch held to its plain version), then ``--restart`` for
   2 more steps, resuming likewise; the same command with
   ``--data_on_device`` (no loader thread, no host batch), checked alike.
   Each command must exit 0 and leave its checkpoints, metrics.jsonl keys
   and audio files; the kernel's launches are counted with the counts set
   to 0 just before each command and read just after.  The steps are
   timed as a user runs them (``step_clock``): a synchronize only where
   the command waits for the card anyway (each signature's first step,
   which compiles or captures, checkpoints, validation, the last step), so
   the host may run ahead between them.  Printed: each command's wall ms a
   step, over all its steps and over those after the last first step of a
   signature (the callbacks' own work left out), its
   median host ms between callbacks per kind beside phases 8 and 10's
   (which synchronize every step), the loader's ms a batch and the
   requests that found its queue empty, the checkpoints' sizes; no
   module of FORBIDDEN_MODULES may be imported.
13. export and serving, from phase 12's runs (the base codec run ``ae``,
   non-causal, so it streams through the crossfade path, and the
   diffusion run ``diff`` trained through it): ``after-tpu-torch export``
   on the card (chunk 4, nb_steps 4, guidance_timbre 2.0), the same with
   ``--batch_size 2`` and ``export_autoencoder`` of the codec run, each
   timed, with the bytes of each file; a fresh ``ExportedStreamer`` reads
   the artifact back (its load time, with the capture of its 3 + 16 stage
   graphs), runs 2 warm-up buffers, then phase 6's request as 64 buffers
   at nb_steps 1 and at 4 and 64 buffers with nb_steps and both guidances
   changing, beside the live ``Streamer`` on the same checkpoints' weights
   (the EMA in the denoiser) with the same noise: outputs within
   GRAPH_TOL, 96 kernel launches a buffer counted on the device (counts
   set to 0 just before each run and read just after), no capture after
   the load, the state at fixed addresses, median / p90 / max ms a buffer
   of both; one artifact buffer under torch.profiler as in phase 4, its
   kernel ms and busy time kept only from a profile that recorded every
   launch the device counted (up to PROFILE_TRIES profiles); the host ms
   of the live streamer's ``capture_key``; the
   two-voice artifact on the card against the same artifact moved to the
   CPU (``move_to_device_pass``, the op's plain version there),
   STREAM_VS_CPU_BUFFERS buffers of fixed noise within CARD_VS_CPU_TOL,
   the reading op by op with TF32 allowed beside it; the codec artifact's
   ``forward`` against the live crossfade codec within GRAPH_TOL; then
   ``after-tpu-torch serve --artifact``, started in its own process on
   127.0.0.1 and a free port before those two checks, answers ``GET
   /api/info``, ``POST /api/timbre`` and ``POST /api/transfer`` with a 3 s
   WAV (200 each, a finite WAV of whole buffers back), each request
   timed, and is stopped.

14. dataset preparation, with phase 12's codec run: a synthetic corpus of
   WAV files from the seed (files of 3 and 3.5 chunks of PREP_SAMPLES,
   the last padded; a shorter file, tiled; a file whose second chunk is
   silent; 9 chunks kept) and two synthetic reference checkpoints (the
   port's random basic-pitch model, its heads' biases at -4 so that its
   activations are sparse, and the full-size Beat This model, under the
   reference's key names); first the kernel against its plain version at
   every ConvBlock1d shape of an encode at batch PREP_BATCH, as phase 3
   does; then ``after-tpu-torch prepare_dataset`` on the card with
   ``--num_signal PREP_SAMPLES --batch_size PREP_BATCH --cut_silences
   --augmentations 1 --descriptors all --beat_track --beat_this_ckpt
   --midi --basic_pitch --save_waveform``: its encodes (2 batches of
   originals, the second padded, and 2 of augmentations) each launching
   the kernel once a ConvBlock1d, counted on the device (counts set to 0
   just before the command and read just after); every record's keys,
   shapes, finite values, chunk indices and MIDI; the z of two records
   against the port's plain versions on the CPU within CARD_VS_CPU_TOL,
   the TF32 reading beside it; ``--parser simple_midi --midi`` slicing a
   .mid file; one encoded batch under torch.profiler (the kernel's share
   of its device time, busy time, idle share; profiled before the
   commands), kept only from a profile that recorded every launch the
   device counted, as in phase 13, and the kernel's share of the batch's
   synchronized wall time, from its CUDA-event ms at these shapes; a
   second ``prepare_dataset`` run in the same process, whose wall time
   less the models' construction gives the steady records/s; ``train`` for
   PREP_TRAIN_STEPS steps on the prepared store; ``update_dataset`` of it,
   each record's new z within GRAPH_TOL of a direct encode, the kernel's
   launches counted on the device.  Printed with the card's name and power
   limit: the command's wall seconds and records/s (start-up, model
   construction and first calls inside) beside the steady records/s, ms
   an encoded batch
   (synchronized), Beat This ms a chunk, basic-pitch ms a file, the host
   ms of augmentation and descriptors a record.

15. the native streaming host (after_tpu_torch/csrc/stream_host.cc), on
   phase 13's artifacts: the host and its op library built with the C++
   compiler against libtorch (the kernel with nvcc), and the stages the
   host plays packaged with AOTInductor, the main artifact, the two-voice
   one and the codec artifact for the card and the two-voice one for the
   CPU, each timed, in parallel processes started as phase 13 exports
   each artifact, at the lowest CPU priority, beside the rest of phase 13
   and phases 16-18 (which run before this phase's host checks; phase 14
   runs last), stopped while those phases time a section and killed with
   the script; the program links no libpython.  The Python hosts phase 13
   loaded give their outputs while the packages compile; then the host as
   a subprocess, with ``--x0`` set to the
   noise the Python host is given: phase 6's request as 64 buffers at
   nb_steps 1 and 4 (readback depth 1) against ``ExportedStreamer`` on
   the same inputs within CARD_VS_CPU_TOL, their median / p90 / max ms a
   buffer side by side; 64 buffers with nb_steps and both guidances
   changing through AFTER_NATIVE_CTRL; ``--pcm`` through pipes against
   file mode within GRAPH_TOL; the two-voice artifact on the card against
   the Python host and against the same host with ``--device cpu`` (the
   op's plain version) within CARD_VS_CPU_TOL (these last three runs, which
   are not timed, at once); the codec artifact against
   ``ExportedCodec``.  The host counts the kernel's launches on the
   device: 96 a buffer (64 a codec forward), its split sum's as phase 6.
   Printed with the card's name and power limit: build and packaging
   seconds, the host's ms a buffer beside the Python host's, the kernel's
   bound a codec artifact forward.

16. bf16 serving (``compute_dtype="bfloat16"``) on phase 4's weights,
   cast once: the bf16 kernel (``snake_conv_bf16``: a producer warp's TMA
   ring of 64-channel stages, the snake by the consumer warpgroups, A by
   ldmatrix, persistent blocks; ``csrc/snake_conv_bf16.cuh``) at every
   shape of a bf16 transfer and of a bf16 buffer, each printed with its
   plan (frames and channels a tile, channels a stage, ring slots, splits,
   blocks), against its plain bf16 version (within BF16_ULPS bf16 ulps of
   max |y|) and against float64 on the same bf16 inputs (within
   BF16_F64_RATIO x bf16 F.conv1d's error), timed with CUDA graphs beside
   its plain version and bf16 F.conv1d, against its bound (989 TFLOP/s of
   dense bf16 or 3.35 TB/s), and its bf16 split sum alone as in phase 3; 3 bf16 transfers replayed from their
   graph (96 bf16 launches a replay and no f32 one counted on the device,
   the output f32 and finite, its cosine to phase 4's f32 output of the
   same request and noise at least BF16_COS) and op by op, per-phase ms,
   one profiled replay; card against CPU in bf16 on phase 5's clip: the
   card's bf16 output within BF16_CARD_CPU_TOL x max |y| of the CPU's bf16
   output and at a cosine of at least BF16_CARD_CPU_COS to it, and its
   distance from the CPU's f32 output at most twice the CPU bf16 output's
   plus 1e-6 x max |y| (the rule of tests/test_torch_precision.py);
   the bf16 streamer on phase 4's first request as 64 buffers at nb_steps 1
   and 4 as graphs and its first EAGER_STREAM_BUFFERS op by op (96 bf16
   launches a buffer, its state's floating leaves bf16, graph and op by
   op within GRAPH_TOL); a bf16
   artifact of phase 12's runs (``export --compute_dtype bfloat16``), its
   manifest's state_dtypes holding bfloat16, its size beside phase 13's
   f32 artifact's, loaded and played as 64 buffers at nb_steps 4 against
   the live bf16 streamer over the same checkpoints within GRAPH_TOL;
17. bf16 training (``compute_dtype="bfloat16"``, f32 masters cast inside
   each step): (a) phase 8's codec, discriminator, batch and schedule at
   bf16 for BF16_TRAIN_STEPS steps of ``fit``, then BF16_DFT_STEPS more
   with ``stft_bf16_dft``: metrics finite, no update skipped, the right
   model moved, parameters and both optimizers' states f32; on the device
   each step 32 bf16 forward launches (the encoder) and 32 f32 ones (the
   decoder: the bottleneck's f32 noise promotes it, as in the JAX
   trainer), each generator step 32 bf16 and 32 f32 dgrad and wgrad
   launches, a discriminator step none; each kind's median, peak memory,
   one profiled bf16 GAN generator step; (b) the bf16 backward kernels
   (``snake_conv_dgrad_bf16``, the forward's bf16 main loop on g with the
   taps reversed and its epilogue; ``snake_conv_wgrad_bf16``, x's tiles
   activated in place and read MN-major, g's fragments by ldmatrix
   .trans) at every shape of the encoder at batch 8, each printed with
   both plans, against their plain bf16 version (within BF16_ULPS bf16
   ulps of each gradient's max; gw zero past C), against float64 (within
   BF16_GRAD_F64_RATIO x bf16 F.conv1d autograd's error), the same bits
   twice and from a graph, timed from CUDA graphs per generator step
   beside the plain version and bf16 F.conv1d's autograd backward
   (cudnn.benchmark off and on), against the bound at 989 TFLOP/s or
   3.35 TB/s; (c) a bf16 GAN generator and discriminator step card vs CPU
   at phase 9's size and noise (BF16_TRAIN_CPU_TOL, set above the
   reading); (d) phase 10's config and batches at bf16, DIFF_STEPS steps
   as CUDA graphs and op by op under cuDNN's deterministic algorithms:
   every kind, at most DIFF_MAX_GRAPHS captures, the same bits, masters,
   EMA, statistics and optimizer states f32, medians, peak memory, one
   profiled replayed phase-2 step; (e) ``train_autoencoder`` and ``train``
   at bf16 from stores under build/cli16, 2 steps each, then a restart
   for one more whose state is the saved one, f32 checkpoints, each
   snake+conv launch of the restarts (the codec's steps, the diffusion
   run's validation through the codec run at step 3) held to its plain
   version of its type.

18. the alternative diffusion models, each at the base preset's widths
   with port-native weights from the seed: ``diffusion_type="edm"``
   (Heun's sampler), ``denoiser.arch="v1"`` (``v1_cross_attn_causal``) and
   ``"unet1d"``.  For each, phase 4's second request as a transfer at 20
   steps through its CUDA graph (first call, then ALT_TRANSFERS replays
   with the device's counts set to 0 just before and read just after: 96
   snake+conv launches a transfer) and op by op (each of its 96 launches
   held to the op's plain version, graph and op by op within GRAPH_TOL),
   their median ms; the card against the CPU on phase 5's clip within
   CARD_VS_CPU_TOL; EDM and v1 streamed as ALT_STREAM_BUFFERS buffers at
   nb_steps 4 as CUDA graphs (96 launches a buffer counted on the device,
   no capture after ``init_state``), their median / p90 / max ms; the
   streamer refusing the UNet.  Then EDM training at phase 10's config,
   batch and bank: ALT_TRAIN_KINDS as graphed steps of ``fit`` (phase 2,
   then cycle; 2 captures), finite losses, each step's ms.  Printed with
   the card's name and power limit.

19. the codec's and the encoders' alternatives at base widths with
   port-native weights from the seed: (a) ``AutoencoderTrainer`` with the
   base codec at ``use_noise=True`` and ``DiscriminatorConfig(kind=
   "descript")`` (periods 2-11, FFT sizes 2048/1024/512) at phase 8's
   batch: CODEC_ALT_WARMUP warm-up generator steps, then CODEC_ALT_STEPS
   GAN generator and discriminator steps by turns, each timed (medians),
   finite metrics, 64 forward, 64 dgrad and 64 wgrad launches a generator
   step and 64 forward launches a discriminator step, counted on the
   device; at the weights those steps leave, one GAN generator step at
   batch 1 and TRAIN_VS_CPU_SAMPLES with fixed bottleneck and decoder
   noise on the card and the CPU in f32, each held to a float64 run on
   the card (``codec_step_witness``: with the MR-STFT's log-magnitude
   term, which f32 does not resolve, printed, the losses within
   CARD_VS_CPU_TOL; without it the card within phase 9's limits of
   float64); the same step card vs
   CPU at the seed's weights, as phase 9 (losses within CARD_VS_CPU_TOL,
   codec gradients within phase 9's limits);
   (b) that codec in the base pipeline: phase 4's second request as a
   transfer through its CUDA graph (CODEC_ALT_TRANSFERS replays, 96
   launches each counted on the device, the two equal: the decoder's
   fixed noise) and op by op (each launch held to the plain version,
   graph and op by op within GRAPH_TOL), the card against the CPU on
   phase 5's clip (the CPU keeping the card's decoder draw) within
   CARD_VS_CPU_TOL; (c) the crossfade streamer of that pipeline,
   CODEC_ALT_BUFFERS buffers at nb_steps 4 (96 launches a buffer, no
   capture after ``init_state``); (d) diffusion training at phase 10's
   config with ECAPA ``regularisation="vae"`` and Encoder1D
   ``vae_regularisation`` and ``upscale_out`` (VAE_OVERRIDES): one
   phase-2 step op by op and captured, then VAE_TRAIN_STEPS replays,
   finite losses (both KLs in cond_reg and time_cond_reg), each step's ms.

Any failure exits non-zero.  The phases run in the order 1-13, 16, 17,
18, 19, 15, 14.  The card's name and power limit are printed again at the end.
The line before the last is the kernel table as JSON (the snake+conv
kernel, its split sum, the backward's dgrad and wgrad kernels, the bf16
instantiation and its split sum, the bf16 dgrad and wgrad); each phase's
seconds are printed as it
ends, and the seconds the background packaging was stopped for timed
sections with phase 15; the last line is ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX or of after_tpu.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from collections import Counter

N_SAMPLES = 524288
NB_STEPS = 20
GUIDANCE_TIMBRE = 2.0
N_REQUESTS = 3
SHORT_SAMPLES = 65536
SHORT_STEPS = 4
SEED = 0
CHUNK = 4                    # latent frames per streamed buffer
N_FADE = 4                   # crossfade overlap, latent frames
STREAM_STEPS = (1, 4)        # nb_steps of the two timed streams
STREAM_WARMUP = 2
STREAM_VS_CPU_BUFFERS = 4
EAGER_STREAM_BUFFERS = 16    # buffers of phase 16's op-by-op streams
PEAK_TF32_FLOPS = 495e12     # H100 SXM, dense TF32 on the tensor cores
PEAK_F32_FLOPS = 67e12       # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 on the tensor cores
# a kernel timed against its byte bound reads inputs the L2 cache (50 MB
# on an H100) does not hold: one call on each of a set of inputs this large
ROTATE_BYTES = 4 * 50e6
F64_FRAMES = 2048            # frames per shape in the float64 check, over
                             # the batch: a max over more frames is larger
F64_RATIO = 4.0              # kernel error <= F64_RATIO * strict F.conv1d's
KERNEL_TOL = 1e-4            # max abs error <= KERNEL_TOL * max |y|
CARD_VS_CPU_TOL = 1e-4       # max abs error <= CARD_VS_CPU_TOL * max |y_cpu|
# CUDA graph against the same call run op by op: the same kernels on the
# same inputs, so equal in practice
GRAPH_TOL = 1e-6             # max abs difference <= GRAPH_TOL * max |y|
KERNEL_NAME = "snake_conv_3xtf32"   # the kernel's device function
SUM_NAME = "sum_splits"      # its second kernel, for split channel sums
DGRAD_NAME = "snake_conv_dgrad_3xtf32"   # the backward's kernels
WGRAD_NAME = "snake_conv_wgrad_3xtf32"
PARTIALS_NAME = "sum_partials"           # their fixed-order sum of partials
STREAM_CHANGING = 64         # buffers of the stream whose attributes change
KERNEL16_NAME = "snake_conv_bf16"   # the kernel's bf16 instantiation
SUM16_NAME = "sum_splits_bf16"      # and its split sum (f32 in, bf16 out)
BF16_ULPS = 2                # bf16 kernel vs its plain bf16 version, in bf16
                             # ulps of max |y| (both round an f32 sum once)
BF16_F64_RATIO = 2.0         # bf16 kernel's float64 error <= this x bf16
                             # F.conv1d's on the same bf16 activation
BF16_COS = 0.99              # a bf16 transfer's cosine to the f32 one (the
                             # JAX package's bound, tests/test_precision.py)
# the card's bf16 transfer of phase 5's clip against the CPU's bf16 one: 1.5x
# the reading of an H100 run (max abs err 0.1315 x max |y|, 1 - cosine
# 0.00507 at SHORT_STEPS; PERF.md section 6), so that a fault on either
# side shows
BF16_CARD_CPU_TOL = 0.2      # max abs err <= this x max |y|
BF16_CARD_CPU_COS = 0.9925   # cosine >= this
TOP_KERNELS = 12
# the port's kernels that use TF32 on purpose (3xTF32, held to float64 in
# the kernel phase); any other kernel with "tf32" in its name fails the run
PORT_TF32_KERNELS = ("snake_conv_3xtf32", DGRAD_NAME, WGRAD_NAME)
TRAIN_STEPS = 10
TRAIN_WARMUP = 2             # AETrainConfig.warmup_steps in phase 8
TRAIN_KINDS = ["warmup"] * 3 + ["gan", "disc", "gan", "gan", "gan", "disc",
                                "gan"]
GRAD_TOL = 1e-4              # Function vs plain autograd, x max |g|
TRAIN_VS_CPU_SAMPLES = 16384
# card vs CPU gradients in phase 9, per tensor, x the larger of its max |g|
# and 1e-3 x the model's largest gradient: the worst tensor and the median
# over tensors of each model.  The discriminator's hinge gradients are the
# difference of a real and a generated chain of similar size, so in f32
# both devices stand 1e-2 from float64 on its worst tensors
# (scripts/torch_train_grads_f64.py)
TRAIN_GRAD_TOL = {"codec": 2e-3, "disc": 5e-2}
TRAIN_GRAD_MEDIAN_TOL = 2e-3
DIFF_STEPS = 15
DIFF_BATCH = 32
DIFF_FRAMES = 128            # latent frames a crop (n_signal)
DIFF_SCHEDULE = {"train.timbre_warmup": 3, "train.adversarial_warmup": 4,
                 "train.update_classifier_every": 3,
                 "train.cycle_start_step": 6,
                 "train.stop_training_encoder_step": 9}
DIFF_KINDS = (["phase1"] * 3 + ["diffusion", "classifier", "classifier",
                                "diffusion", "classifier", "classifier",
                                "cycle", "classifier", "classifier", "cycle",
                                "classifier", "classifier"])
DIFF_COLLATE_STEPS = 5       # batches from the host collate, then the bank
DIFF_MAX_GRAPHS = 5          # step signatures of the curriculum
# graphs against op by op, and windows against single steps: the same draws
# and kernels, but cuDNN's weight gradients add in no fixed order, and Adam
# turns a gradient that is rounding noise around 0 into a step of either
# sign, so two runs part more with each step.  On an H100 two op-by-op
# runs of the 15 steps read 3.8e-4 x max(|v|, 0.01) apart on a metric and
# 7.4 x lr on a parameter after 8 updates; graphs against op by op read
# 1.4e-4 to 5.5e-4 over three runs.  Metrics within DIFF_GRAPH_TOL x
# max(|v|, 0.01).  The parameters' limit, DIFF_GRAPH_LR_TOL x lr an update,
# is about as far as any two Adam runs can part (an update moves a
# parameter by about lr whatever its gradient), so it is a reading, not a
# check of the gradients: the check is the pair run with cuDNN's
# deterministic algorithms, where a graph run and an op-by-op run are held
# to the same bits.
DIFF_GRAPH_TOL = 3e-3
DIFF_GRAPH_LR_TOL = 2.0
DIFF_WINDOW = 3              # steps_per_call of the windowed run
# its callbacks: windows [0, 3) and [3, 6), single steps where a curriculum
# boundary (7, 10) falls inside a window, the window [12, 15)
DIFF_WINDOW_STEPS = [3, 6, 7, 8, 9, 10, 11, 12, 15]
# the longer run: phase 1 (0-2), 11 diffusion steps (3-33), 12 cycle steps
# (36-69; the timbre encoder frozen after 45), the classifier steps between
DIFF_LONG_SCHEDULE = {"train.cycle_start_step": 33,
                      "train.stop_training_encoder_step": 45}
DIFF_LONG_STEPS = 70
DIFF_RECORDS = 32            # synthetic latent records of (64, 4096)
DIFF_RECORD_FRAMES = 4096
DIFF_VAL_BATCHES = 2
DIFF_VS_CPU_BATCH = 4
# card vs CPU gradients in phase 11, per tensor, x the larger of its max |g|
# and 1e-3 x its model's largest gradient: the worst tensor of any model
# and the median over each model's tensors.  Read on an H100 in strict f32:
# worst 1.06e-02 (an ECAPA conv, whose gradients sum nearly cancelling
# terms), medians up to 1.06e-03; with TF32 allowed 1.31e-01, medians
# 2.9e-03 to 5.7e-02
DIFF_GRAD_TOL = 3e-2
DIFF_GRAD_MEDIAN_TOL = 2e-3
CLI_DIR = "build/cli"         # phase 12's stores and runs
CLI_RECORDS = 16             # waveform records of about 3 s
CLI_RECORD_SAMPLES = 132300  # 3 s at 44.1 kHz
CLI_AE_STEPS = 10
CLI_AE_EVERY = 5             # the codec run's checkpoints and validation
CLI_DIFF_STEPS = DIFF_LONG_STEPS
# what phase 12 may not find imported, though the card machine lacks most
FORBIDDEN_MODULES = ("jax", "flax", "after_tpu", "google.protobuf", "yaml")
EXPORT_STEPS = 4             # the artifact's default nb_steps
SERVE_SECONDS = 3.0          # the WAV posted to the server
SERVE_START_TIMEOUT = 300    # seconds for the server to print its address
SERVE_REQUEST_TIMEOUT = 120
DEVICE = "cuda"              # where phase 13 exports, serves and streams
PREP_SAMPLES = N_SAMPLES      # phase 14's chunks (--num_signal)
PREP_BATCH = 8               # and encode batch (--batch_size)
PREP_SHORT_SAMPLES = 300000  # a file shorter than a chunk, tiled
PREP_TRAIN_STEPS = 3         # train's steps on the prepared store
# phase 18: the alternative diffusion models at the base preset's widths
ALT_MODELS = (("edm", {"diffusion_type": "edm"}),
              ("v1", {"denoiser.arch": "v1",
                      "denoiser.v1_cross_attn_causal": True}),
              ("unet1d", {"denoiser.arch": "unet1d"}))
ALT_TRANSFERS = 2            # timed transfers a model, graph and op by op
ALT_STREAM_BUFFERS = 16      # streamed buffers of EDM and v1
ALT_STREAM_STEPS = 4
ALT_TRAIN_SCHEDULE = {"train.timbre_warmup": 0,
                      "train.update_classifier_every": 1,
                      "train.cycle_start_step": 2}
ALT_TRAIN_KINDS = ["diffusion"] * 3 + ["cycle"] * 2
PROFILE_TRIES = 3            # profiles of an artifact buffer, for one that
                             # kept every kernel record
NATIVE_JOB_LOGS = "build/native_jobs"   # phase 15's package jobs' output
# phase 19: the codec's and the encoders' alternatives at base widths
CODEC_ALT_WARMUP = 2         # warm-up generator steps (no GAN terms)
CODEC_ALT_STEPS = 3          # timed GAN generator and discriminator steps
CODEC_ALT_TRANSFERS = 2      # timed transfers, graph and op by op
CODEC_ALT_BUFFERS = 16       # streamed buffers at ALT_STREAM_STEPS
VAE_TRAIN_STEPS = 3          # replayed phase-2 steps with VAE encoders
VAE_OVERRIDES = {"encoder.regularisation": "vae",
                 "encoder_time.vae_regularisation": True,
                 "encoder_time.ac_regularisation": False,
                 "encoder_time.upscale_out": True}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


_CLOCK = {}


def phase_time(label: str) -> None:
    """Logs the seconds since the last call (the phases just ended) and
    since the first."""
    now = time.perf_counter()
    start = _CLOCK.setdefault("start", now)
    last = _CLOCK.get("last", start)
    _CLOCK["last"] = now
    if label != "start":
        log(f"time: {label} {now - last:.1f} s, the script so far "
            f"{now - start:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3, graph: bool = True
            ) -> float:
    """Device time of one call of fn, in ms: CUDA events around reps calls
    captured in a CUDA graph and replayed, so that host work between the
    launches does not count (graph=False times eager calls instead)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    g = None
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        g.replay()
    else:
        for _ in range(reps):
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rotating_ms(fn, inputs) -> float:
    """Device time of one call of fn, in ms, on an input that comes from
    HBM: one call on each of ``inputs`` (together larger than the L2 cache)
    captured in one CUDA graph, every output kept, so that no call reads
    or writes where another has just left its data in the cache."""
    held, it = [], iter(inputs * 2)
    ms = cuda_ms(lambda: held.append(fn(next(it))), reps=len(inputs),
                 warmup=1)
    held.clear()
    return ms


def vjp_ms(fwd, args, gy, reps: int = 5, wrt=None) -> float:
    """Device time of one backward of fwd(*args) against gy, in ms: the
    forward captured in one CUDA graph and reps backwards in a second on
    the same pool and stream, as torch.cuda.make_graphed_callables captures
    a backward; CUDA events around the backward graph's replay.  The
    gradient is taken for the args whose ``wrt`` flag is set (all by
    default).  The inputs are fresh leaves: a leaf already used on the
    default stream carries that stream in its gradient node, and a captured
    backward would wait on it."""
    import torch
    wrt = [True] * len(args) if wrt is None else wrt
    args = [a.detach().clone().requires_grad_(n) for a, n in zip(args, wrt)]
    leaves = [a for a in args if a.requires_grad]
    torch.cuda.synchronize()
    with torch.cuda.stream(torch.cuda.Stream()):
        for _ in range(2):
            torch.autograd.grad(fwd(*args), leaves, gy)
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    g_fwd, g_bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(g_fwd, pool=pool):
        y = fwd(*args)
    with torch.cuda.graph(g_bwd, pool=pool):
        for _ in range(reps):
            torch.autograd.grad(y, leaves, gy, retain_graph=True)
    g_fwd.replay()
    g_bwd.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g_bwd.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def codec_conv_blocks(codec, n_samples: int):
    """(ConvBlock1d, T) of one encode and of one decode, in path order."""
    cfg = codec.cfg
    T = n_samples // cfg.pqmf_bands
    enc, dec = [], []

    def res(out, rb, T):
        out += [(rb.block1, T), (rb.block2, T)]

    res(enc, codec.encoder.to_in, T)
    for i, f in enumerate(cfg.factors):
        blk = getattr(codec.encoder, f"down_{i}")
        for j in range(blk.num_layers):
            res(enc, getattr(blk, f"res_{j}"), T)
        T //= f
    for i, f in enumerate(cfg.factors[::-1]):
        T *= f
        blk = getattr(codec.decoder, f"up_{i}")
        for j in range(blk.num_layers):
            res(dec, getattr(blk, f"res_{j}"), T)
    res(dec, codec.decoder.to_out, T)
    return enc, dec


def block_shape(block, T: int):
    c = block.conv
    return (c.kernel_size, c.dilation, c.in_features, c.features, T, c.mode)


def f64_errors(x, alpha, beta, w, b, d, mode):
    """Max abs errors against a float64 plain version on F64_FRAMES frames
    (the first F64_FRAMES / B of each of the B signals): the kernel,
    strict-f32 F.conv1d and TF32 F.conv1d (the last two through the plain
    version, snake in f32)."""
    import torch
    from after_tpu_torch.ops.kernels.fused_conv import (fused_snake_conv,
                                                        snake_conv_reference)
    from after_tpu_torch.utils.device import strict_f32

    x = x[:, :max(1, F64_FRAMES // x.shape[0])].contiguous()
    ref = snake_conv_reference(x.double(), alpha.double(), beta.double(),
                               w.double(), b.double(), d, mode)
    y = fused_snake_conv(x, alpha, beta, w, b, d, mode)
    strict = snake_conv_reference(x, alpha, beta, w, b, d, mode)
    torch.backends.cudnn.allow_tf32 = True
    tf32 = snake_conv_reference(x, alpha, beta, w, b, d, mode)
    strict_f32()
    return tuple((t.double() - ref).abs().max().item()
                 for t in (y, strict, tf32))


def check_fused_conv(path, unit, batch: int = 1):
    """Kernel vs plain version at every distinct shape of ``path``, a list of
    (ConvBlock1d, T) in the order one ``unit`` (a transfer, a buffer, a
    training codec forward) runs them at ``batch``; returns its numbers
    summed over one unit."""
    import torch
    import torch.nn.functional as F
    from after_tpu_torch.ops.conv import get_padding
    from after_tpu_torch.ops.kernels.fused_conv import (kernel_plan,
                                                        snake_conv,
                                                        snake_conv_reference,
                                                        sum_splits,
                                                        sum_splits_reference)
    from after_tpu_torch.ops.snake import snake_beta

    path_counts = Counter(block_shape(b, T) for b, T in path)
    blocks_by_shape = {block_shape(b, T): b for b, T in path}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    total = Counter()
    splits = Counter()       # (splits, B, T, O) of the split sum -> launches
    worst = 0.0
    f64_worst = (0.0, 0.0, 0.0)
    log("kernels: device times from CUDA graphs of 20 calls each")
    log(f"kernels: fused_snake_conv at batch {batch}, per shape (k d C O T "
        f"mode: n/{unit}, "
        "plan bn/bk/splits, max_abs_err; kernel/plain/F.conv1d/bound(3xTF32)/"
        "bound(f32) ms; TFLOP/s, share of bound; float64 errors kernel/"
        "F.conv1d/F.conv1d-TF32)")
    for shape, block in sorted(blocks_by_shape.items(),
                               key=lambda kv: str(kv[0])):
        k, d, C, O, T, mode = shape
        n = path_counts[shape]
        x = torch.randn((batch, T, C), generator=gen, device="cuda")
        alpha, beta = block.act.alpha.detach(), block.act.beta.detach()
        # the weight in the kernel's layout with its low tf32 half, as the
        # main path passes it, and in torch's layout for the plain version
        w_k, w_lo = block.conv.kernel_weights()
        w = block.conv.effective_weight()
        b = block.conv.bias.detach()
        y = snake_conv(x, alpha, beta, w_k, w_lo, b, d, mode)
        ref = snake_conv_reference(x, alpha, beta, w, b, d, mode)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not (err <= KERNEL_TOL * scale):
            fail(f"fused_snake_conv {shape}: max abs err {err} > "
                 f"{KERNEL_TOL} * {scale}")
        worst = max(worst, err)
        e64 = f64_errors(x, alpha, beta, w, b, d, mode)
        if not (e64[0] <= F64_RATIO * e64[1]):
            fail(f"fused_snake_conv {shape}: error against float64 {e64[0]} "
                 f"> {F64_RATIO} x strict-f32 F.conv1d's {e64[1]}")
        f64_worst = tuple(max(a, c) for a, c in zip(f64_worst, e64))
        left, right = get_padding(k, 1, d, mode)
        a = F.pad(snake_beta(x, alpha, beta).transpose(1, 2), (left, right))
        wc = w.contiguous()
        ms = cuda_ms(lambda: snake_conv(x, alpha, beta, w_k, w_lo, b, d,
                                        mode))
        eager_ms = cuda_ms(
            lambda: snake_conv(x, alpha, beta, w_k, w_lo, b, d, mode),
            graph=False)
        plain_ms = cuda_ms(
            lambda: snake_conv_reference(x, alpha, beta, w, b, d, mode))
        lib_ms = cuda_ms(lambda: F.conv1d(a, wc, b, dilation=d))
        flops = 2.0 * k * C * O * T * batch
        nbytes = 4.0 * (batch * T * C + 2 * C + O * C * k + O
                        + batch * T * O)
        bound_ms = 1e3 * max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES)
        bound_f32_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        total.update(ms=n * ms, eager_ms=n * eager_ms, plain_ms=n * plain_ms,
                     library_ms=n * lib_ms,
                     bound_ms=n * bound_ms, bound_f32_ms=n * bound_f32_ms,
                     flops=n * flops, bytes=n * nbytes)
        plan = kernel_plan(batch, T, C, O, k, d)
        log(f"  {k} {d} {C} {O} {T} {mode}: {n}, {'/'.join(map(str, plan))}"
            f", {err:.3e}; "
            f"{ms:.4f}/{plain_ms:.4f}/{lib_ms:.4f}/{bound_ms:.4f}/"
            f"{bound_f32_ms:.4f}; {flops / ms / 1e9:.1f}, "
            f"{bound_ms / ms:.3f}; {e64[0]:.3e}/{e64[1]:.3e}/{e64[2]:.3e}")
        if plan[2] > 1:
            splits[(plan[2], batch, T, O)] += n
    total["launches"] = len(path)
    # the split sum alone at each split shape: against its plain version
    # (the same adds in the same order: equal bits) and torch.sum, each
    # timed on partial sums that come from HBM, where its byte bound holds
    # (on the main path the conv kernel has just written them, so they may
    # still sit in the L2 cache)
    log(f"kernels: {SUM_NAME} at each split shape of the {unit} (splits B T "
        f"O: n/{unit}, inputs rotated, max_abs_err; kernel/plain/torch.sum/"
        f"bound(bytes) ms, share of bound)")
    sum_err = 0.0
    for (parts, B_, T_, O_), n in sorted(splits.items()):
        nbytes = 4.0 * (parts + 1) * B_ * T_ * O_
        wss = [torch.randn((parts, B_, T_, O_), generator=gen, device="cuda")
               for _ in range(max(2, math.ceil(ROTATE_BYTES / nbytes)))]
        err = max((sum_splits(ws) - sum_splits_reference(ws)).abs().max()
                  .item() for ws in wss[:2])
        if err != 0:
            fail(f"{SUM_NAME} {tuple(wss[0].shape)}: {err} off its plain "
                 f"version")
        sum_err = max(sum_err, err)
        ms = rotating_ms(sum_splits, wss)
        plain_ms = rotating_ms(sum_splits_reference, wss)
        lib_ms = rotating_ms(lambda ws: torch.sum(ws, dim=0), wss)
        del wss
        bound_ms = 1e3 * nbytes / PEAK_BYTES
        total.update(sum_ms=n * ms, sum_plain_ms=n * plain_ms,
                     sum_library_ms=n * lib_ms, sum_bound_ms=n * bound_ms,
                     sum_launches=n)
        log(f"  {parts} {B_} {T_} {O_}: {n}, {err:.1e}; {ms:.4f}/"
            f"{plain_ms:.4f}/{lib_ms:.4f}/{bound_ms:.4f}, "
            f"{bound_ms / ms:.3f}")
        if bound_ms > ms:
            fail(f"{SUM_NAME} {(parts, B_, T_, O_)}: {ms:.4f} ms beats its "
                 f"byte bound {bound_ms:.4f} ms: the bound is wrong")
    total["sum_max_abs_err"] = sum_err
    log(f"kernels: {SUM_NAME} per {unit} ({total['sum_launches']} launches):"
        f" kernel {total['sum_ms']:.4f} ms, plain {total['sum_plain_ms']:.4f}"
        f" ms, torch.sum {total['sum_library_ms']:.4f} ms, bound "
        f"{total['sum_bound_ms']:.4f} ms (bytes at {PEAK_BYTES / 1e12} TB/s), "
        f"{total['sum_bound_ms'] / max(total['sum_ms'], 1e-12):.3f} of it")
    total["bound_by"] = ("operations" if 3 * total["flops"] / PEAK_TF32_FLOPS
                         >= total["bytes"] / PEAK_BYTES else "bytes")
    total["tflops"] = total["flops"] / total["ms"] / 1e9
    total["share"] = total["bound_ms"] / total["ms"]
    total["max_abs_err"] = worst
    total["f64"] = f64_worst
    log(f"kernels: fused_snake_conv per {unit} ({len(path)} launches, "
        f"{total['flops'] / 1e9:.2f} GFLOP): kernel {total['ms']:.3f} ms "
        f"({total['tflops']:.1f} TFLOP/s, {total['share']:.3f} of the "
        f"bound; {total['eager_ms']:.3f} ms launched eagerly from Python), "
        f"plain {total['plain_ms']:.3f} ms, F.conv1d "
        f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.4f} ms "
        f"(3xTF32 tensor cores, {total['bound_by']}; on the f32 CUDA cores "
        f"{total['bound_f32_ms']:.4f} ms); max abs err {worst:.3e}; against "
        f"float64: kernel {f64_worst[0]:.3e}, F.conv1d {f64_worst[1]:.3e}, "
        f"F.conv1d with TF32 {f64_worst[2]:.3e}")
    return total


def check_gradients(path, batch: int):
    """The op's gradient on the card, the backward's kernels, at every
    distinct shape of ``path`` at ``batch``:

    - through autograd (``fused_snake_conv``) against plain autograd, each
      input's gradient within GRAD_TOL x its max |g|;
    - the op ``snake_conv_backward`` against its plain version (the VJP of
      the plain forward), each of the five gradients within KERNEL_TOL x
      its max |g|, the weight gradient's padded columns zero; on
      F64_FRAMES frames against a float64 plain backward, the kernels'
      error (the worst tensor's, over its max |g|) within F64_RATIO x that
      of the plain backward in strict f32 (cuDNN's F.conv1d autograd);
    - the same bits from two launches and from a launch replayed from a
      CUDA graph;
    - times from CUDA graphs: the whole backward through autograd (and
      eager), dgrad alone (the op asked for x, alpha, beta and b; with the
      weight copy it makes, also timed alone) and wgrad alone (asked for
      w), each beside the plain backward asked for the same and F.conv1d's
      autograd backward for the same gradients (input; weight and bias),
      and F.conv1d's whole autograd backward, each with cudnn.benchmark off
      and on.

    Returns these numbers summed over one generator step's launches."""
    import torch
    import torch.nn.functional as F
    from after_tpu_torch.ops.conv import get_padding, weight_norm
    from after_tpu_torch.ops.kernels.fused_conv import (
        backward_plan, backward_weight, fused_snake_conv, kernel_weight,
        snake_conv_backward, snake_conv_backward_reference,
        snake_conv_reference)
    from after_tpu_torch.ops.snake import snake_beta

    counts = Counter(block_shape(b, T) for b, T in path)
    blocks = {block_shape(b, T): b for b, T in path}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    every = [True] * 5
    want = {"dgrad": [True, True, True, False, True],
            "wgrad": [False, False, False, True, False]}
    tot = Counter()
    worst = Counter()
    log(f"gradients: the op's backward kernels at batch {batch} (k d C O T "
        "mode: n, plan dgrad bn/bk/partial rows wgrad bn/splits; worst "
        "|g - g_plain| / max|g_plain| through autograd, the op's dgrad and "
        "wgrad tensors; float64 errors kernels/strict f32; ms from CUDA "
        "graphs: backward (eager), dgrad (weight copy), wgrad, plain "
        "dgrad/wgrad, F.conv1d input/weight (cudnn.benchmark on), whole "
        "F.conv1d benchmark off/on, bound 3xTF32 dgrad/wgrad)")
    for shape, block in sorted(blocks.items(), key=lambda kv: str(kv[0])):
        k, d, C, O, T, mode = shape
        n = counts[shape]
        with torch.no_grad():
            w = weight_norm(block.conv.weight, block.conv.g)
        x = torch.randn((batch, T, C), generator=gen, device="cuda")
        alpha, beta = block.act.alpha.detach(), block.act.beta.detach()
        b = block.conv.bias.detach()
        gy = torch.randn((batch, T, O), generator=gen, device="cuda")
        args = [x, alpha, beta, w, b]
        ours = [a.clone().requires_grad_() for a in args]
        y = fused_snake_conv(*ours, d, mode)
        g_ours = torch.autograd.grad(y, ours, gy, retain_graph=True)
        plain = [a.clone().requires_grad_() for a in args]
        g_plain = torch.autograd.grad(snake_conv_reference(*plain, d, mode),
                                      plain, gy)
        ratio = max((a - p).abs().max().item() / p.abs().max().item()
                    for a, p in zip(g_ours, g_plain))
        if not ratio <= GRAD_TOL:
            fail(f"snake_conv's gradient {shape}: differs from plain "
                 f"autograd by {ratio:.3e} x max|g| > {GRAD_TOL}")
        worst["autograd"] = max(worst["autograd"], ratio)

        # the op against its plain version, tensor by tensor
        w_k = kernel_weight(w)[0]
        op_args = (gy, x, alpha, beta, w_k, b, d, mode)
        got = snake_conv_backward(*op_args, every)
        ref = snake_conv_backward_reference(*op_args, every)
        rel = {}
        for i, (name, a, r) in enumerate(zip("x alpha beta w b".split(), got,
                                             ref)):
            err = (a - r).abs().max().item()
            scale = r.abs().max().item()
            if not err <= KERNEL_TOL * scale:
                fail(f"snake_conv_backward {shape}: g{name} max abs err "
                     f"{err} > {KERNEL_TOL} * {scale}")
            kind = "wgrad" if i == 3 else "dgrad"
            rel[kind] = max(rel.get(kind, 0.0), err / scale)
            worst[kind] = max(worst[kind], err / scale)
            worst[kind + "_abs"] = max(worst[kind + "_abs"], err)
        if got[3][:, :, C:].any():
            fail(f"snake_conv_backward {shape}: gw's padded columns are not "
                 "zero")
        # the same bits again, and replayed from a CUDA graph
        again = snake_conv_backward(*op_args, every)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            captured = snake_conv_backward(*op_args, every)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"snake_conv_backward {shape}: two launches differ")
        if not all(torch.equal(a, c) for a, c in zip(got, captured)):
            fail(f"snake_conv_backward {shape}: a CUDA graph replay differs "
                 "from the eager launch")
        del graph, captured, again, got, ref
        # against float64 on the first F64_FRAMES frames
        f = max(1, F64_FRAMES // batch)
        cut = (gy[:, :f].contiguous(), x[:, :f].contiguous(), alpha, beta,
               w_k, b, d, mode)
        r64 = snake_conv_backward_reference(
            *(t.double() if torch.is_tensor(t) else t for t in cut), every)

        def err64(ts):
            return max(((a.double() - r).abs().max() / r.abs().max()).item()
                       for a, r in zip(ts, r64))
        e64 = (err64(snake_conv_backward(*cut, every)),
               err64(snake_conv_backward_reference(*cut, every)))
        if not e64[0] <= F64_RATIO * e64[1]:
            fail(f"snake_conv_backward {shape}: error against float64 "
                 f"{e64[0]:.3e} > {F64_RATIO} x the strict-f32 plain "
                 f"backward's {e64[1]:.3e}")
        worst["f64"] = max(worst["f64"], e64[0])
        worst["f64_plain"] = max(worst["f64_plain"], e64[1])

        # times
        ms = vjp_ms(lambda *t: fused_snake_conv(*t, d, mode), ours, gy)
        eager = cuda_ms(lambda: torch.autograd.grad(y, ours, gy,
                                                    retain_graph=True),
                        reps=5, warmup=1, graph=False)
        t = {kind: cuda_ms(lambda: snake_conv_backward(*op_args, m), reps=5,
                           warmup=1) for kind, m in want.items()}
        t_plain = {kind: cuda_ms(
            lambda: snake_conv_backward_reference(*op_args, m), reps=5,
            warmup=1) for kind, m in want.items()}
        copy_ms = cuda_ms(lambda: backward_weight(w_k, C), reps=5, warmup=1)
        left, right = get_padding(k, 1, d, mode)
        a_pad = F.pad(snake_beta(x, alpha, beta).transpose(1, 2),
                      (left, right))
        gyt = gy.transpose(1, 2).contiguous()

        def conv(a, wl, bl):
            return F.conv1d(a, wl, bl, dilation=d)
        # F.conv1d's autograd backward for each kernel's gradients (input;
        # weight and bias) and for all three, cudnn.benchmark off and on
        lib, whole = {}, []
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            lib["dgrad", bench] = vjp_ms(conv, [a_pad, w, b], gyt,
                                         wrt=[True, False, False])
            lib["wgrad", bench] = vjp_ms(conv, [a_pad, w, b], gyt,
                                         wrt=[False, True, True])
            whole.append(vjp_ms(conv, [a_pad, w, b], gyt))
        torch.backends.cudnn.benchmark = False
        flops = 2.0 * k * C * O * T * batch
        nbytes = {"dgrad": 4.0 * (2 * batch * T * C + batch * T * O
                                  + k * O * C + 4 * C + O),
                  "wgrad": 4.0 * (batch * T * C + batch * T * O + 2 * C
                                  + k * O * w_k.shape[2])}
        bound = {kind: 1e3 * max(3 * flops / PEAK_TF32_FLOPS,
                                 nbytes[kind] / PEAK_BYTES)
                 for kind in want}
        for kind in want:
            tot[f"{kind}_ms"] += n * t[kind]
            tot[f"{kind}_plain_ms"] += n * t_plain[kind]
            tot[f"{kind}_library_ms"] += n * lib[kind, False]
            tot[f"{kind}_library_benchmark_ms"] += n * lib[kind, True]
            tot[f"{kind}_bound_ms"] += n * bound[kind]
            tot[f"{kind}_flops"] += n * flops
            tot[f"{kind}_bytes"] += n * nbytes[kind]
        tot.update(ms=n * ms, eager_ms=n * eager, copy_ms=n * copy_ms,
                   library_ms=n * whole[0], library_benchmark_ms=n * whole[1],
                   plain_f32_flops=n * 3 * flops, launches=n)
        plan = backward_plan(batch, T, C, O, k, d)
        tot["partial_sums"] += n * (1 + (plan[4] > 1))
        log(f"  {k} {d} {C} {O} {T} {mode}: {n}, "
            f"{'/'.join(map(str, plan))}; {ratio:.2e} {rel['dgrad']:.2e} "
            f"{rel['wgrad']:.2e}; {e64[0]:.2e}/{e64[1]:.2e}; {ms:.4f} "
            f"({eager:.4f}), {t['dgrad']:.4f} ({copy_ms:.4f}), "
            f"{t['wgrad']:.4f}, {t_plain['dgrad']:.4f}/{t_plain['wgrad']:.4f}"
            f", {lib['dgrad', False]:.4f}/{lib['wgrad', False]:.4f} "
            f"({lib['dgrad', True]:.4f}/{lib['wgrad', True]:.4f}), "
            f"{whole[0]:.4f}/"
            f"{whole[1]:.4f}, {bound['dgrad']:.4f}/{bound['wgrad']:.4f}")
    for kind in want:
        ops = 3 * tot[f"{kind}_flops"] / PEAK_TF32_FLOPS
        tot[f"{kind}_bound_by"] = ("operations" if ops >= tot[f"{kind}_bytes"]
                                   / PEAK_BYTES else "bytes")
    tot["bound_ms"] = tot["dgrad_bound_ms"] + tot["wgrad_bound_ms"]
    tot["bound_f32_ms"] = 1e3 * tot["plain_f32_flops"] / PEAK_F32_FLOPS
    tot.update({f"worst_{k}": v for k, v in worst.items()})
    log(f"gradients: per generator step ({tot['launches']} launches of each "
        f"kernel, {tot['partial_sums']} of {PARTIALS_NAME}): the backward "
        f"through autograd {tot['ms']:.3f} ms from CUDA graphs "
        f"({tot['eager_ms']:.3f} ms eager); dgrad {tot['dgrad_ms']:.3f} ms "
        f"(its weight copy {tot['copy_ms']:.3f}), wgrad "
        f"{tot['wgrad_ms']:.3f} ms; the plain backward's dgrad "
        f"{tot['dgrad_plain_ms']:.3f} ms and wgrad "
        f"{tot['wgrad_plain_ms']:.3f} ms; F.conv1d's autograd backward "
        f"{tot['library_ms']:.3f} ms with cudnn.benchmark off, "
        f"{tot['library_benchmark_ms']:.3f} ms with it on (input alone "
        f"{tot['dgrad_library_ms']:.3f} and "
        f"{tot['dgrad_library_benchmark_ms']:.3f}, weight and bias alone "
        f"{tot['wgrad_library_ms']:.3f} and "
        f"{tot['wgrad_library_benchmark_ms']:.3f}); bound on the 3xTF32 "
        f"tensor cores "
        f"{tot['dgrad_bound_ms']:.3f} + {tot['wgrad_bound_ms']:.3f} = "
        f"{tot['bound_ms']:.3f} ms ({tot['dgrad_bound_by']}; "
        f"{2 * tot['dgrad_flops'] / 1e9:.1f} GFLOP), the plain VJP's "
        f"recompute + dgrad + wgrad on the f32 CUDA cores "
        f"{tot['bound_f32_ms']:.3f} ms; worst error ratios: autograd "
        f"{worst['autograd']:.3e} (limit {GRAD_TOL}), dgrad "
        f"{worst['dgrad']:.3e}, wgrad {worst['wgrad']:.3e} (limit "
        f"{KERNEL_TOL}); against float64 kernels {worst['f64']:.3e}, strict "
        f"f32 plain {worst['f64_plain']:.3e}")
    return tot


def synthetic_audio(gen, batch: int, n: int, sr: int):
    """(batch, n, 1) waveforms on the card: three sinusoids of random
    frequency (110-1760 Hz), phase and level, plus noise; peaks near 0.2."""
    import torch
    t = torch.arange(n, device="cuda") / sr
    f = 110.0 * 2.0 ** (4.0 * torch.rand((batch, 3, 1), generator=gen,
                                         device="cuda"))
    phase = 2 * math.pi * torch.rand((batch, 3, 1), generator=gen,
                                     device="cuda")
    level = 0.03 + 0.04 * torch.rand((batch, 3, 1), generator=gen,
                                     device="cuda")
    x = (level * torch.sin(2 * math.pi * f * t + phase)).sum(1)
    x = x + 0.02 * torch.randn((batch, n), generator=gen, device="cuda")
    return x[..., None]


def flat_params(module):
    import torch
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def train_phase(row) -> None:
    """Phase 8: codec training at full width (see the module docstring)."""
    import torch
    from after_tpu_torch.autoencoder import AutoencoderTrainer
    from after_tpu_torch.config import (AETrainConfig, DiscriminatorConfig,
                                        get_ae_config)
    from after_tpu_torch.ops.kernels.fused_conv import (
        backward_device_launches, fused_snake_conv, reset_device_launches)

    ae = get_ae_config()
    tc = AETrainConfig(warmup_steps=TRAIN_WARMUP)
    t0 = time.perf_counter()
    trainer = AutoencoderTrainer(ae, tc, DiscriminatorConfig(),
                                 device="cuda", seed=SEED).init(SEED)
    torch.cuda.synchronize()
    n_codec = sum(p.numel() for p in trainer.codec.parameters())
    n_disc = sum(p.numel() for p in trainer.disc.parameters())
    log(f"training: base codec ({n_codec} parameters) and discriminator "
        f"({n_disc}), port-native init (seed {SEED}) in "
        f"{time.perf_counter() - t0:.2f} s; batch {tc.batch_size} x "
        f"{tc.num_signal} samples, {len(tc.stft_fft_sizes)} MR-STFT scales, "
        f"warmup_steps {tc.warmup_steps}")
    kinds = [trainer.step_kind(i) for i in range(TRAIN_STEPS)]
    if kinds != TRAIN_KINDS:
        fail(f"fit's schedule {kinds} differs from {TRAIN_KINDS}")
    enc, dec = codec_conv_blocks(trainer.codec, tc.num_signal)
    per_forward = len(enc) + len(dec)
    gen = torch.Generator("cuda").manual_seed(SEED)
    batches = [synthetic_audio(gen, tc.batch_size, tc.num_signal, ae.sr)
               for _ in range(TRAIN_STEPS + 1)]

    records = []
    snap = {"codec": flat_params(trainer.codec),
            "disc": flat_params(trainer.disc)}

    def callback(tr, metrics):
        torch.cuda.synchronize()
        dt = time.perf_counter() - snap["t0"]
        kind = kinds[tr.step - 1]
        launches = fused_snake_conv.launches - snap["launches"]
        # the backward's kernels, counted on the device over this step
        bwd = backward_device_launches()
        reset_device_launches()
        values = {k: float(v) for k, v in metrics.items()}
        codec, disc = flat_params(tr.codec), flat_params(tr.disc)
        moved = (not torch.equal(codec, snap["codec"]),
                 not torch.equal(disc, snap["disc"]))
        records.append((kind, dt, launches, values, moved, bwd))
        log(f"training: step {tr.step - 1} ({kind}): {dt * 1e3:.2f} ms, "
            f"fused_snake_conv launches +{launches}, backward launches "
            f"(dgrad, wgrad, {PARTIALS_NAME}) {bwd} on the device, " +
            ", ".join(f"{k} {v:.5g}" for k, v in values.items()))
        snap.update(codec=codec, disc=disc,
                    launches=fused_snake_conv.launches)
        torch.cuda.synchronize()
        snap["t0"] = time.perf_counter()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused_snake_conv.launches = 0
    snap["launches"] = 0
    reset_device_launches()
    torch.cuda.synchronize()
    snap["t0"] = time.perf_counter()
    trainer.fit(iter(batches[:TRAIN_STEPS]), max_steps=TRAIN_STEPS,
                callback=callback)
    launches = fused_snake_conv.launches
    peak = torch.cuda.max_memory_allocated()
    if launches == 0 or len(records) != TRAIN_STEPS:
        fail(f"fit ran {len(records)} steps with {launches} kernel launches")
    for i, (kind, _, n, values, (codec_moved, disc_moved), bwd) in enumerate(
            records):
        if n != per_forward:
            fail(f"training step {i}: {n} kernel launches, expected "
                 f"{per_forward} (one codec forward)")
        # a generator step differentiates every conv of the codec: each
        # asks for every gradient, so each launches dgrad and wgrad once; a
        # discriminator step runs the codec without gradients
        want = per_forward if kind != "disc" else 0
        if bwd[:2] != (want, want):
            fail(f"training step {i} ({kind}): backward launches {bwd} on "
                 f"the device, expected {want} dgrad and {want} wgrad")
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"training step {i}: non-finite metrics {values}")
        if values.get("skipped_nonfinite", 0) != 0:
            fail(f"training step {i}: a generator update was skipped")
        want = (True, False) if kind != "disc" else (False, True)
        if (codec_moved, disc_moved) != want:
            fail(f"training step {i} ({kind}): codec moved {codec_moved}, "
                 f"discriminator moved {disc_moved}")
    if trainer.disc_optimizer.total_notfinite:
        fail("a discriminator update was skipped")
    medians = {}
    for kind in ("warmup", "gan", "disc"):
        times = [dt for k, dt, *_ in records if k == kind][1:]
        medians[kind] = sorted(times)[len(times) // 2] * 1e3
    log(f"training: {TRAIN_STEPS} steps, {launches} kernel launches "
        f"({per_forward} a step); median host ms without each kind's first "
        f"step: warm-up generator {medians['warmup']:.2f}, GAN generator "
        f"{medians['gan']:.2f}, discriminator {medians['disc']:.2f}; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    w_wave, w_reg = trainer._recon_weights(trainer.step)
    profile_call("one GAN generator step", lambda: trainer.gen_step(
        batches[-1], True, w_wave, w_reg))

    blocks = [b for b, _ in enc + dec]

    def split_weights():
        with torch.enable_grad():
            for b in blocks:
                b.conv.kernel_weights()
    wn_ms = cuda_ms(split_weights, reps=5, warmup=1, graph=False)
    log(f"training: weight norm + the kernel's weight split per codec "
        f"forward ({len(blocks)} convs, eager): {wn_ms:.3f} ms")

    with torch.no_grad():
        per_forward_k = check_fused_conv(enc + dec, "training codec forward",
                                         tc.batch_size)
    bwd = check_gradients(enc + dec, tc.batch_size)
    bwd_launches = [sum(r[5][i] for r in records) for i in range(3)]
    want_sums = sum(1 for k in kinds if k != "disc") * bwd["partial_sums"]
    if bwd_launches[2] != want_sums:
        fail(f"training: {bwd_launches[2]} {PARTIALS_NAME} launches on the "
             f"device, expected {want_sums}")
    rows = [backward_row(kind, bwd, n)
            for kind, n in zip(("dgrad", "wgrad"), bwd_launches)]
    row.update({
        "launches_training": launches,
        "launches_per_gen_step": per_forward,
        "launches_per_disc_step": per_forward,
        "ms_per_codec_forward_training": per_forward_k["ms"],
        "bound_ms_per_codec_forward_training": per_forward_k["bound_ms"],
        "bound_by_training": per_forward_k["bound_by"],
        "plain_ms_per_codec_forward_training": per_forward_k["plain_ms"],
        "library_ms_per_codec_forward_training": per_forward_k["library_ms"],
        "tflops_training": per_forward_k["tflops"],
        "backward_ms_per_gen_step": bwd["ms"],
        "backward_eager_ms_per_gen_step": bwd["eager_ms"],
        "backward_library_ms_per_gen_step": bwd["library_ms"],
        "backward_library_benchmark_ms_per_gen_step":
            bwd["library_benchmark_ms"],
        "backward_bound_ms_per_gen_step": bwd["bound_ms"],
        "backward_bound_f32_ms_per_gen_step": bwd["bound_f32_ms"],
        "backward_launches_training": bwd_launches,
        "grad_err_training": bwd["worst_autograd"],
        "weight_split_ms_per_codec_forward": wn_ms,
        "step_ms_median": medians,
        "training_peak_memory_gib": peak / 2**30,
        "max_abs_err": max(row["max_abs_err"], per_forward_k["max_abs_err"]),
        "f64_err": max(row["f64_err"], per_forward_k["f64"][0]),
        "f64_err_conv1d": max(row["f64_err_conv1d"], per_forward_k["f64"][1]),
        "f64_err_conv1d_tf32": max(row["f64_err_conv1d_tf32"],
                                   per_forward_k["f64"][2]),
    })
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def train_card_vs_cpu() -> None:
    """Phase 9: one GAN generator step and one discriminator step on the
    card and on the CPU, same weights, batch and noise."""
    import numpy as np
    import torch
    from after_tpu_torch.autoencoder import AutoencoderTrainer
    from after_tpu_torch.config import (AETrainConfig, DiscriminatorConfig,
                                        get_ae_config)
    from after_tpu_torch.utils.device import strict_f32

    ae = get_ae_config()
    tc = AETrainConfig(warmup_steps=TRAIN_WARMUP, batch_size=1,
                       num_signal=TRAIN_VS_CPU_SAMPLES)
    card = AutoencoderTrainer(ae, tc, DiscriminatorConfig(), device="cuda"
                              ).init(SEED)
    cpu = AutoencoderTrainer(ae, tc, DiscriminatorConfig(), device="cpu")
    cpu.codec.load_state_dict(card.codec.state_dict())
    cpu.disc.load_state_dict(card.disc.state_dict())
    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    x = synthetic_audio(gen, 1, TRAIN_VS_CPU_SAMPLES, ae.sr).cpu().numpy()
    noise = np.random.RandomState(SEED + 4).randn(
        1, TRAIN_VS_CPU_SAMPLES // ae.ratio, ae.z_channels).astype(np.float32)
    w_wave, w_reg = card._recon_weights(TRAIN_WARMUP + 1)

    def run(tr):
        gm, gg = tr.gen_grads(x, True, w_wave, w_reg, noise)
        dm, dg = tr.disc_grads(x, noise)
        return ({**{k: float(v) for k, v in gm.items()},
                 **{"disc_" + k: float(v) for k, v in dm.items()}},
                [g.cpu() for g in gg], [g.cpu() for g in dg])

    def compare(a, b):
        """Run a against run b (the CPU's): the worst relative loss error,
        and per model the worst tensor's gradient ratio, its name and the
        median ratio over tensors."""
        loss = max(abs(a[0][k] - v) / max(abs(v), 1e-2)
                   for k, v in b[0].items())
        grads = {}
        for model, module, ga, gb in (("codec", card.codec, a[1], b[1]),
                                      ("disc", card.disc, a[2], b[2])):
            floor = 1e-3 * max(g.abs().max().item() for g in gb)
            ratios = sorted(
                ((p - q).abs().max().item() / max(q.abs().max().item(),
                                                  floor), n)
                for (n, _), p, q in zip(module.named_parameters(), ga, gb))
            grads[model] = (*ratios[-1], ratios[len(ratios) // 2][0])
        return loss, grads

    on_cpu = run(cpu)
    loss, grads = compare(run(card), on_cpu)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    loss_tf32, grads_tf32 = compare(run(card), on_cpu)
    strict_f32()
    log(f"training card vs CPU: {TRAIN_VS_CPU_SAMPLES} samples, GAN "
        f"generator and discriminator step, fixed noise: losses within "
        f"{loss:.3e} x max(|loss|, 0.01) (limit {CARD_VS_CPU_TOL}; with TF32 "
        f"allowed {loss_tf32:.3e}); " + ", ".join(
            f"{k} {v:.5g}" for k, v in on_cpu[0].items()))
    ok = loss <= CARD_VS_CPU_TOL
    for model in ("codec", "disc"):
        worst, name, median = grads[model]
        worst_t, name_t, median_t = grads_tf32[model]
        log(f"training card vs CPU, {model} gradients (x max(max|g|, 1e-3 x "
            f"the model's largest)): worst {worst:.3e} ({name}; limit "
            f"{TRAIN_GRAD_TOL[model]}), median {median:.3e} (limit "
            f"{TRAIN_GRAD_MEDIAN_TOL}); with TF32 allowed worst {worst_t:.3e} "
            f"({name_t}), median {median_t:.3e}")
        ok = (ok and worst <= TRAIN_GRAD_TOL[model]
              and median <= TRAIN_GRAD_MEDIAN_TOL)
    if not ok:
        fail("training: card and CPU disagree")
    return grads


def synthetic_latents(n: int, channels: int, frames: int, seed: int):
    """n latent records (channels, frames), float32 numpy: three sinusoids
    of random slow frequency, phase and level a channel, plus noise."""
    import numpy as np
    rng = np.random.RandomState(seed)
    t = np.arange(frames)
    out = []
    for _ in range(n):
        f = rng.uniform(0.002, 0.05, (channels, 3, 1))
        phase = rng.uniform(0, 2 * np.pi, (channels, 3, 1))
        level = rng.uniform(0.3, 1.0, (channels, 3, 1))
        z = (level * np.sin(2 * np.pi * f * t + phase)).sum(1)
        out.append((z + 0.3 * rng.randn(channels, frames)).astype(np.float32))
    return out


def diffusion_config(in_size: int = 64, **overrides):
    from after_tpu_torch.config import get_config, with_overrides
    cfg = get_config("base", "cycle").resolved(in_size=in_size,
                                               n_signal=DIFF_FRAMES)
    return with_overrides(cfg, {**DIFF_SCHEDULE,
                                "train.batch_size": DIFF_BATCH, **overrides})


def diffusion_phase(row, codec) -> None:
    """Phase 10: diffusion training at full width (see the module
    docstring); ``codec`` is the base codec whose checkpoint the validation
    round trip loads."""
    import itertools
    import os

    import numpy as np
    import torch
    from after_tpu_torch.cli.train import (make_codec_coder,
                                           val_transfer_margin, validate)
    from after_tpu_torch.config import ae_to_json, to_json
    from after_tpu_torch.dataset import DeviceLatentBank, make_collate_fn
    from after_tpu_torch.diffusion.trainer import (DIFFUSION_METRICS,
                                                   DiffusionTrainer)
    from after_tpu_torch.models.autoencoder import ConvBlock1d
    from after_tpu_torch.ops.kernels.fused_conv import (fused_snake_conv,
                                                        snake_conv_reference)
    from after_tpu_torch.ops.norms import BatchNorm
    from after_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)
    from torch.nn.modules.module import (register_module_forward_hook,
                                         register_module_forward_pre_hook)

    cfg = diffusion_config()
    t0 = time.perf_counter()
    tr = DiffusionTrainer(cfg, device="cuda", seed=SEED).init(SEED)
    torch.cuda.synchronize()
    counts = {n: sum(p.numel() for p in m.parameters())
              for n, m in tr._models().items()}
    log(f"diffusion: base + cycle config, n_signal {DIFF_FRAMES}, batch "
        f"{DIFF_BATCH}, parameters {counts}, port-native init (seed {SEED}) "
        f"in {time.perf_counter() - t0:.2f} s")
    kinds = [tr.step_kind(i) for i in range(DIFF_STEPS)]
    if kinds != DIFF_KINDS:
        fail(f"fit's schedule {kinds} differs from {DIFF_KINDS}")
    # every run of the phase starts from these weights
    weights0 = {k: v.clone() for k, v in tr.rf.state_dict().items()}

    items = [{"z": z} for z in synthetic_latents(
        DIFF_RECORDS, cfg.denoiser.n_channels, DIFF_RECORD_FRAMES, SEED)]
    bank = DeviceLatentBank(items, DIFF_FRAMES, device="cuda")

    def host_batch(collate_fn, pick, batch=DIFF_BATCH):
        return collate_fn([items[i] for i in
                           pick.randint(0, len(items), batch)])

    def batches():
        """The phase's batches, the same in every run: the first from the
        host collate, the rest from the bank on the card."""
        collate = make_collate_fn(DIFF_FRAMES, seed=SEED)
        pick = np.random.RandomState(SEED)
        return itertools.chain(
            (host_batch(collate, pick) for _ in range(DIFF_COLLATE_STEPS)),
            bank.batches(DIFF_BATCH, seed=SEED))

    log(f"diffusion: {DIFF_RECORDS} synthetic latent records of "
        f"({cfg.denoiser.n_channels}, {DIFF_RECORD_FRAMES}); steps 0-"
        f"{DIFF_COLLATE_STEPS - 1} from the host collate, the rest from a "
        f"DeviceLatentBank of {bank.nbytes / 2**20:.1f} MiB on the card")

    def trainer(run_cfg=cfg, eager=False):
        """A trainer of the phase's weights (port-native, drawn on the CPU
        from the seed) and generator seed."""
        t = DiffusionTrainer(run_cfg, device="cuda", seed=SEED,
                             eager=eager).init(SEED)
        if not all(torch.equal(v, weights0[k])
                   for k, v in t.rf.state_dict().items()):
            fail("init(SEED) gave other weights")
        return t

    def bn_stats(module):
        return torch.cat([m.running_mean for m in module.modules()
                          if isinstance(m, BatchNorm)])

    def snapshot(t):
        return {"net": flat_params(t.rf.net), "encoder": flat_params(
            t.rf.encoder), "encoder_time": flat_params(t.rf.encoder_time),
            "classifier": flat_params(t.rf.classifier),
            "ema": torch.cat([e.reshape(-1) for e in t.ema]),
            "encoder_stats": bn_stats(t.rf.encoder)}

    def signature(t, step):
        kind = t.step_kind(step)
        return (kind,) if kind == "classifier" else (kind, *t.step_flags(step))

    def run(t, max_steps, moved_check=False, batch_iter=None):
        """fit over max_steps steps: per callback (step, kind of its last
        step, host ms ending in a synchronize, metrics as floats, captures so
        far, what moved)."""
        records = []
        snap = {"state": snapshot(t) if moved_check else None}

        def callback(tt, metrics):
            torch.cuda.synchronize()
            dt = time.perf_counter() - snap["t0"]
            step = tt.step - 1
            values = {k: float(v) for k, v in metrics.items()}
            moved = None
            if moved_check:
                state = snapshot(tt)
                moved = {k: not torch.equal(v, snap["state"][k])
                         for k, v in state.items()}
                snap["state"] = state
            records.append((step, tt.step_kind(step), dt, values,
                            tt.graphs.captures if tt.graphs else 0, moved))
            torch.cuda.synchronize()
            snap["t0"] = time.perf_counter()

        torch.cuda.synchronize()
        snap["t0"] = time.perf_counter()
        t.fit(batch_iter if batch_iter is not None else batches(),
              max_steps=max_steps, callback=callback)
        return records

    def medians(t, records):
        """{kind: (median ms without the first step of each signature, ms
        of the kind's first step, steps run)}."""
        out, seen = {}, set()
        for kind in ("phase1", "diffusion", "cycle", "classifier"):
            times, rest = [], []
            for step, k, dt, *_ in records:
                if k != kind:
                    continue
                times.append(dt)
                sig = signature(t, step)
                if sig in seen:
                    rest.append(dt)
                seen.add(sig)
            rest.sort()
            out[kind] = (rest[len(rest) // 2] * 1e3 if rest else None,
                         times[0] * 1e3 if times else None, len(times))
        return out

    def check_captures(label, t, records):
        """One capture at the first step of each signature, none after."""
        seen, before = set(), 0
        for step, _, _, _, captures, _ in records:
            sig = signature(t, step)
            want = before + (sig not in seen)
            if captures != want:
                fail(f"{label}: {captures} captures after step {step}, "
                     f"expected {want}")
            seen.add(sig)
            before = captures
        if before > DIFF_MAX_GRAPHS:
            fail(f"{label}: {before} graphs, more than {DIFF_MAX_GRAPHS}")
        return before

    def gap(a, b):
        """max |a - b| / max(|b|, 0.01) over b's metrics."""
        return max(abs(a[k] - v) / max(abs(v), 1e-2) for k, v in b.items())

    # the main path: 15 steps of fit as CUDA graphs, every step kind
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    records = run(tr, DIFF_STEPS, moved_check=True)
    peak = torch.cuda.max_memory_allocated()
    if len(records) != DIFF_STEPS:
        fail(f"fit ran {len(records)} steps, expected {DIFF_STEPS}")
    for step, kind, dt, values, captures, moved in records:
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"diffusion step {step}: non-finite metrics {values}")
        if values.get("skipped_nonfinite", 0) != 0:
            fail(f"diffusion step {step}: an update was skipped")
        if kind == "classifier":
            want = {"net": False, "encoder": False, "encoder_time": False,
                    "classifier": True, "ema": False,
                    "encoder_stats": False}
        else:
            phase1, train_enc, train_enc_t, _ = tr.step_flags(step)
            want = {"net": True, "encoder": train_enc,
                    "encoder_time": train_enc_t and not phase1,
                    "classifier": False, "ema": True, "encoder_stats": True}
        if moved != want:
            fail(f"diffusion step {step} ({kind}): moved {moved}, "
                 f"expected {want}")
        log(f"diffusion: step {step} ({kind}) as a graph: {dt * 1e3:.2f} ms "
            f"(captures so far {captures}), moved " + ",".join(
                k for k, m in moved.items() if m) + "; " + ", ".join(
                f"{k} {v:.5g}" for k, v in values.items()))
    if int(tr.cls_optimizer.total_notfinite):
        fail("a classifier update was skipped")
    n_graphs = check_captures("graphs, 15 steps", tr, records)
    pool_mib = tr.graphs.held_bytes()
    log(f"diffusion: {n_graphs} graphs captured (one at the first step of "
        f"each signature, none after) in {tr.graphs.capture_seconds:.2f} s; "
        f"graph pool " + (f"{pool_mib / 2**20:.1f} MiB" if pool_mib
                          is not None else "not measured")
        + f"; peak device memory {peak / 2**30:.2f} GiB")

    # the same 15 steps op by op, from the same weights and generator seed
    eager = trainer(eager=True)
    e_records = run(eager, DIFF_STEPS)
    if eager.graphs is not None:
        fail("the eager trainer captured a graph")
    worst = max(gap(g[3], e[3]) for g, e in zip(records, e_records))
    lr = cfg.train.lr
    p_gap = {}
    for name in ("net", "encoder", "encoder_time", "classifier"):
        a, b = (flat_params(getattr(t.rf, name)) for t in (tr, eager))
        p_gap[name] = (a - b).abs().max().item() / lr
    updates = max(int(tr.optimizer.count), int(tr.cls_optimizer.count))
    equal = all(torch.equal(a, b) for a, b in zip(
        tr.rf.state_dict().values(), eager.rf.state_dict().values()))
    log(f"diffusion: graphs vs op by op over {DIFF_STEPS} steps: metrics "
        f"within {worst:.3e} x max(|v|, 0.01) (limit {DIFF_GRAPH_TOL}); "
        f"final parameters within " + ", ".join(
            f"{k} {v:.3e}" for k, v in p_gap.items())
        + f" x lr (a reading; limit {DIFF_GRAPH_LR_TOL} x lr x {updates} "
        f"updates); bitwise equal: {equal} (the check is the deterministic "
        f"pair below)")
    if not (worst <= DIFF_GRAPH_TOL
            and max(p_gap.values()) <= DIFF_GRAPH_LR_TOL * updates):
        fail("diffusion: the graphs and the op-by-op steps disagree")
    # the same pair with cuDNN's deterministic algorithms: the same kernels
    # on the same inputs and draws, so the same bits
    torch.backends.cudnn.deterministic = True
    try:
        pair = [trainer(eager=e) for e in (False, True)]
        det = [run(t, DIFF_STEPS) for t in pair]
    finally:
        torch.backends.cudnn.deterministic = False
    same_metrics = all(a[3] == b[3] for a, b in zip(*det))
    same_state = all(torch.equal(a, b) for a, b in zip(
        *(list(t.rf.state_dict().values()) + t.ema
          + [t.optimizer._mu, t.optimizer._nu, t.cls_optimizer._mu,
             t.cls_optimizer._nu] for t in pair)))
    log(f"diffusion: graphs vs op by op with cuDNN deterministic, "
        f"{DIFF_STEPS} steps: every step's metrics equal {same_metrics}, "
        f"final weights, statistics, EMA and moments equal {same_state}")
    if not (same_metrics and same_state):
        fail("diffusion: with cuDNN deterministic the graphs and the "
             "op-by-op steps differ")
    del pair, det
    # op by op with host syncs refused: a diffusion, a cycle and a
    # classifier step, each from a host batch
    host = host_batch(make_collate_fn(DIFF_FRAMES, seed=SEED + 2),
                      np.random.RandomState(SEED + 2))
    for label, step in (("diffusion", 3), ("cycle", 9)):
        no_host_sync(f"one op-by-op {label} step", lambda: eager.train_step(
            host, *eager.step_flags(step), *eager.schedule_weights(step)))
    no_host_sync("one op-by-op classifier step",
                 lambda: eager.classifier_step(host))
    del eager

    # steps_per_call = 3 over the same schedule, as graphs
    win = trainer(diffusion_config(**{"train.steps_per_call": DIFF_WINDOW}))
    w_records = run(win, DIFF_STEPS)
    steps = [r[0] + 1 for r in w_records]
    if steps != DIFF_WINDOW_STEPS:
        fail(f"steps_per_call={DIFF_WINDOW}: callbacks at {steps}, "
             f"expected {DIFF_WINDOW_STEPS}")
    per_step = {r[0]: r[3] for r in records}
    worst_w, windows, first = 0.0, [], 0
    for step, _, dt, values, _, _ in w_records:
        rows = [per_step[i] for i in range(first, step + 1)]
        if len(rows) == 1:
            want = rows[0]
        else:
            diff = [r for r in rows if "loss" in r]
            cls = [r for r in rows if "classifier_loss" in r]
            want = {k: sum(r[k] for r in diff) / max(len(diff), 1)
                    for k in DIFFUSION_METRICS}
            want["classifier_loss"] = (sum(r["classifier_loss"] for r in cls)
                                       / max(len(cls), 1))
            windows.append((first, step + 1, dt * 1e3))
        worst_w = max(worst_w, gap(values, want))
        first = step + 1
    log(f"diffusion: steps_per_call={DIFF_WINDOW}: callbacks at {steps}; "
        f"windows " + ", ".join(f"[{a}, {b}) {ms:.2f} ms" for a, b, ms in
                               windows)
        + f"; window metrics within {worst_w:.3e} x max(|v|, 0.01) of the "
        f"single steps' means (limit {DIFF_GRAPH_TOL}); "
        f"{win.graphs.captures} graphs")
    if worst_w > DIFF_GRAPH_TOL:
        fail("diffusion: the windows' metrics differ from the single steps'")
    del win

    # a longer run, graphs and op by op: at least 10 steps of each phase-2
    # kind, for the medians; then as windows of 3 steps, for the median of a
    # window that captures nothing
    long_cfg = diffusion_config(**DIFF_LONG_SCHEDULE)
    long_runs = {}
    for eager_run in (False, True):
        t = trainer(long_cfg, eager=eager_run)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        recs = run(t, DIFF_LONG_STEPS)
        long_runs[eager_run] = (medians(t, recs),
                                torch.cuda.max_memory_allocated() - before)
        if not eager_run:
            check_captures("graphs, long run", t, recs)
            long_pool = t.graphs.held_bytes()
            graphed_long = t
        del t
    t = trainer(diffusion_config(**DIFF_LONG_SCHEDULE,
                                 **{"train.steps_per_call": DIFF_WINDOW}))
    recs = run(t, DIFF_LONG_STEPS)
    steady, last, captured = [], 0, 0
    for step, _, dt, _, captures, _ in recs:
        if step + 1 - last == DIFF_WINDOW and captures == captured:
            steady.append(dt * 1e3)
        last, captured = step + 1, captures
    del t
    if not steady:
        fail("the windowed long run has no window without a capture")
    window_ms = sorted(steady)[len(steady) // 2]
    log(f"diffusion: {DIFF_LONG_STEPS} steps as windows of {DIFF_WINDOW}: "
        f"{len(recs)} callbacks, median of the {len(steady)} windows that "
        f"capture nothing {window_ms:.2f} ms (min {min(steady):.2f}, max "
        f"{max(steady):.2f})")
    for eager_run, (meds, mem) in long_runs.items():
        log(f"diffusion: {DIFF_LONG_STEPS} steps "
            f"{'op by op' if eager_run else 'as CUDA graphs'}: " + "; ".join(
                f"{k} median {m[0]:.2f} ms over {m[2]} (first {m[1]:.2f})"
                for k, m in meds.items() if m[0] is not None)
            + f" (medians without each signature's first step); peak device "
            f"memory {mem / 2**30:.2f} GiB above what the run found "
            f"allocated (weights, optimizers, other trainers)")
    meds_g, meds_e = long_runs[False][0], long_runs[True][0]
    for kind, (_, _, n) in meds_g.items():
        if kind != "phase1" and n < 10:
            fail(f"the long run has {n} {kind} steps")

    # one replayed step of each phase-2 kind under the profiler
    t = graphed_long
    batch = t.upload(next(batches()))
    cycle = DIFF_LONG_SCHEDULE["train.cycle_start_step"] + 3
    profiled = {}
    for kind, step in (("diffusion", DIFF_SCHEDULE["train.timbre_warmup"]),
                       ("cycle", cycle), ("classifier", cycle + 1)):
        if t.step_kind(step) != kind:
            fail(f"step {step} of the long run is not a {kind} step")
        replays = t.graphs.replays
        wall, busy, counts, _ = profile_call(
            f"one replayed phase-2 {kind} step", lambda: (
                t.classifier_step(batch) if kind == "classifier" else
                t.train_step(batch, *t.step_flags(step),
                             *t.schedule_weights(step))))
        if t.graphs.replays != replays + 1:
            fail(f"the profiled {kind} step was not a replay")
        profiled[kind] = {"wall_ms": wall, "busy_ms": busy,
                          "launches": sum(counts.values())}
    del t, graphed_long
    row["diffusion_profiled_replays"] = profiled
    row["diffusion_step_ms_median"] = {k: m[0] for k, m in meds_g.items()}
    row["diffusion_step_ms_median_eager"] = {k: m[0]
                                             for k, m in meds_e.items()}
    row["diffusion_window_ms_median"] = window_ms
    row["diffusion_graphs"] = n_graphs
    row["diffusion_graph_pool_mib"] = (None if long_pool is None
                                       else long_pool / 2**20)

    # checkpoint under build/
    ckpt = os.path.join("build", "diffusion_ckpt")
    t0 = time.perf_counter()
    save_checkpoint(ckpt, tr.step, tr.state_tree(), to_json(cfg))
    restored = restore_checkpoint(ckpt)
    ckpt_s = time.perf_counter() - t0

    if not trees_equal(tr.state_tree(), restored):
        fail("the restored checkpoint differs from the train state")
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(ckpt) for f in fs)
    log(f"diffusion: checkpoint of step {tr.step} saved and restored in "
        f"{ckpt_s:.2f} s ({size / 2**20:.1f} MiB), every tensor equal")

    # validation: loss, then the transfer margin across the codec
    val_collate = make_collate_fn(DIFF_FRAMES, seed=SEED + 1)
    val_pick = np.random.RandomState(SEED + 1)
    val_batches = [host_batch(val_collate, val_pick)
                   for _ in range(DIFF_VAL_BATCHES)]
    t0 = time.perf_counter()
    vloss = validate(tr, val_batches)
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t0) * 1e3
    codec_dir = os.path.join("build", "codec_ckpt")
    save_checkpoint(codec_dir, 0, {"codec_vars": codec.state_dict()},
                    ae_to_json(codec.cfg))
    decode, encode = make_codec_coder(codec_dir, device="cuda")
    seen_z = []

    def dec(z):
        seen_z.append(z)
        return decode(z)

    # the coder's codec is its own: its blocks are found by a global hook
    path = []

    def record(mod, args):
        if isinstance(mod, ConvBlock1d):
            path.append((mod, args[0].shape[1]))

    hook = register_module_forward_pre_hook(record)
    torch.cuda.synchronize()
    fused_snake_conv.launches = 0
    t0 = time.perf_counter()
    margins = val_transfer_margin(tr, val_batches, codec=(dec, encode))
    torch.cuda.synchronize()
    margin_ms = (time.perf_counter() - t0) * 1e3
    launches = fused_snake_conv.launches
    hook.remove()
    if launches == 0 or launches != len(path):
        fail(f"the validation round trip launched fused_snake_conv "
             f"{launches} times for {len(path)} ConvBlock1d calls")
    if not (math.isfinite(vloss)
            and all(math.isfinite(v) for v in margins.values())):
        fail(f"non-finite validation: loss {vloss}, {margins}")
    log(f"diffusion: validate over {DIFF_VAL_BATCHES} batches {vloss:.5g} "
        f"({val_ms:.2f} ms); val_transfer_margin (20 steps, round trip of "
        f"{tuple(seen_z[0].shape)} latents) " + ", ".join(
            f"{k} {v:+.5f}" for k, v in margins.items())
        + f" in {margin_ms:.2f} ms; fused_snake_conv launches {launches}")

    # each launch of the round trip against its plain version
    worst = [0.0]

    def check(mod, args, out):
        if not isinstance(mod, ConvBlock1d):
            return
        h = mod.gn(args[0]) if mod.gn is not None else args[0]
        ref = snake_conv_reference(h.contiguous(), mod.act.alpha,
                                   mod.act.beta, mod.conv.effective_weight(),
                                   mod.conv.bias, mod.conv.dilation,
                                   mod.conv.mode)
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= KERNEL_TOL * scale:
            fail(f"round trip: fused_snake_conv at {tuple(h.shape)} off its "
                 f"plain version by {err} > {KERNEL_TOL} * {scale}")
        worst[0] = max(worst[0], err / scale)

    hook = register_module_forward_hook(check)
    encode(decode(seen_z[0]))
    hook.remove()
    log(f"diffusion: each of the round trip's {launches} launches within "
        f"{worst[0]:.3e} x max|y| of its plain version (limit {KERNEL_TOL})")
    with torch.no_grad():
        per_trip = check_fused_conv(path, "validation round trip",
                                    seen_z[0].shape[0])
    row.update({
        "launches_validation": launches,
        "ms_per_validation_round_trip": per_trip["ms"],
        "bound_ms_per_validation_round_trip": per_trip["bound_ms"],
        "bound_by_validation_round_trip": per_trip["bound_by"],
        "plain_ms_per_validation_round_trip": per_trip["plain_ms"],
        "library_ms_per_validation_round_trip": per_trip["library_ms"],
        "diffusion_peak_memory_gib": peak / 2**30,
        "max_abs_err": max(row["max_abs_err"], per_trip["max_abs_err"]),
        "f64_err": max(row["f64_err"], per_trip["f64"][0]),
        "f64_err_conv1d": max(row["f64_err_conv1d"], per_trip["f64"][1]),
        "f64_err_conv1d_tf32": max(row["f64_err_conv1d_tf32"],
                                   per_trip["f64"][2]),
    })
    del tr, bank, batches
    gc.collect()
    torch.cuda.empty_cache()


def diffusion_card_vs_cpu():
    """Phase 11: one cycle diffusion step and one classifier step on the
    card and on the CPU, same weights, batch and draws, dropouts 0."""
    import numpy as np
    import torch
    from after_tpu_torch.dataset import make_collate_fn
    from after_tpu_torch.diffusion.trainer import (DiffusionTrainer,
                                                   shuffle_index)
    from after_tpu_torch.utils.device import strict_f32

    cfg = diffusion_config(**{"denoiser.dropout": 0.0,
                              "encoder_time.dropout": 0.0,
                              "classifier.dropout": 0.0,
                              "train.batch_size": DIFF_VS_CPU_BATCH})
    card = DiffusionTrainer(cfg, device="cuda").init(SEED)
    cpu = DiffusionTrainer(cfg, device="cpu")
    cpu.rf.load_state_dict(card.rf.state_dict())
    B, T, C = DIFF_VS_CPU_BATCH, DIFF_FRAMES, cfg.denoiser.n_channels
    items = [{"z": z} for z in synthetic_latents(B, C, 512, SEED + 5)]
    batch = make_collate_fn(T, seed=SEED + 5)(items)
    rng = np.random.RandomState(SEED + 5)
    shuffle = shuffle_index(B, T, tuple(cfg.train.shuffle_zsem),
                            torch.Generator().manual_seed(SEED + 5),
                            torch.device("cpu")).numpy()
    draws = {"shuffle": shuffle,
             "cond_noise": rng.randn(B, cfg.zt_channels),
             "time_cond_noise": rng.randn(B, T, cfg.zs_channels),
             "cfg_uniform": rng.uniform(size=B),
             "x0": rng.randn(B, T, C), "t": rng.uniform(size=B),
             "cycle_perm": rng.permutation(B)}
    step = DIFF_SCHEDULE["train.stop_training_encoder_step"]  # a cycle step
    flags, weights = card.step_flags(step), card.schedule_weights(step)
    if card.step_kind(step) != "cycle":
        fail(f"step {step} is not a cycle step")

    def run(tr):
        dm, dg, _ = tr.train_grads(batch, *flags, *weights, draws=draws)
        cm, cg, _ = tr.classifier_grads(batch, {"shuffle": shuffle})
        grads = {n: [g.cpu() for g in gs] for n, gs in dg.items()}
        grads["classifier"] = [g.cpu() for g in cg]
        return {**{k: float(v) for k, v in dm.items()},
                **{k: float(v) for k, v in cm.items()}}, grads

    def compare(a, b):
        loss = max(abs(a[0][k] - v) / max(abs(v), 1e-2)
                   for k, v in b[0].items())
        worst, medians = (0.0, ""), {}
        for model, gb in b[1].items():
            floor = 1e-3 * max(g.abs().max().item() for g in gb)
            if floor == 0:
                continue
            names = [n for n, _ in getattr(
                card.rf, model).named_parameters()]
            ratios = sorted(
                ((p - q).abs().max().item() / max(q.abs().max().item(),
                                                  floor), n)
                for n, p, q in zip(names, a[1][model], gb))
            worst = max(worst, (ratios[-1][0], f"{model}.{ratios[-1][1]}"))
            medians[model] = ratios[len(ratios) // 2][0]
        return loss, worst, medians

    on_cpu = run(cpu)
    loss, worst, medians = compare(run(card), on_cpu)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    loss_t, worst_t, medians_t = compare(run(card), on_cpu)
    strict_f32()
    log(f"diffusion card vs CPU: batch {B}, a cycle step (step {step}) and "
        f"a classifier step, fixed draws: metrics within {loss:.3e} x "
        f"max(|v|, 0.01) (limit {CARD_VS_CPU_TOL}; with TF32 allowed "
        f"{loss_t:.3e}); " + ", ".join(f"{k} {v:.5g}"
                                      for k, v in on_cpu[0].items()))
    log(f"diffusion card vs CPU gradients (x max(max|g|, 1e-3 x the model's "
        f"largest)): worst {worst[0]:.3e} ({worst[1]}; limit {DIFF_GRAD_TOL})"
        f", medians " + ", ".join(f"{k} {v:.3e}" for k, v in medians.items())
        + f" (limit {DIFF_GRAD_MEDIAN_TOL}); with TF32 allowed worst "
        f"{worst_t[0]:.3e} ({worst_t[1]}), medians " + ", ".join(
            f"{k} {v:.3e}" for k, v in medians_t.items()))
    if not (loss <= CARD_VS_CPU_TOL and worst[0] <= DIFF_GRAD_TOL
            and max(medians.values()) <= DIFF_GRAD_MEDIAN_TOL):
        fail("diffusion training: card and CPU disagree")
    return worst[0], max(medians.values())


def kernel_row(per_transfer, per_buffer):
    """The kernel table's row: per transfer (the offline path) and per
    streamed buffer."""
    f64 = tuple(max(a, b) for a, b in zip(per_transfer["f64"],
                                          per_buffer["f64"]))
    return {"name": "fused_snake_conv", "route": "cuda",
            "source": "after_tpu_torch/csrc/fused_snake_conv.cu",
            "replaces": "after_tpu/ops/pallas/fused_conv.py:129",
            "max_abs_err": max(per_transfer["max_abs_err"],
                               per_buffer["max_abs_err"]),
            "ms": per_transfer["ms"], "plain_ms": per_transfer["plain_ms"],
            "bound_ms": per_transfer["bound_ms"],
            "bound_by": per_transfer["bound_by"],
            "library_ms": per_transfer["library_ms"],
            "bound_f32_ms": per_transfer["bound_f32_ms"],
            "tflops": per_transfer["tflops"],
            "eager_ms": per_transfer["eager_ms"],
            "share_of_bound": per_transfer["share"],
            "ms_per_buffer": per_buffer["ms"],
            "bound_ms_per_buffer": per_buffer["bound_ms"],
            "bound_by_per_buffer": per_buffer["bound_by"],
            "library_ms_per_buffer": per_buffer["library_ms"],
            "plain_ms_per_buffer": per_buffer["plain_ms"],
            "eager_ms_per_buffer": per_buffer["eager_ms"],
            "f64_err": f64[0], "f64_err_conv1d": f64[1],
            "f64_err_conv1d_tf32": f64[2]}


def sum_row(per_transfer, per_buffer):
    """The split sum's row: per transfer and per streamed buffer (times
    from CUDA graphs; its bound is the bytes it moves)."""
    return {"name": SUM_NAME, "route": "cuda",
            "source": "after_tpu_torch/csrc/fused_snake_conv.cu",
            "replaces": "after_tpu/ops/pallas/fused_conv.py:129",
            "max_abs_err": max(per_transfer["sum_max_abs_err"],
                               per_buffer["sum_max_abs_err"]),
            "ms": per_transfer["sum_ms"],
            "plain_ms": per_transfer["sum_plain_ms"],
            "bound_ms": per_transfer["sum_bound_ms"], "bound_by": "bytes",
            "library_ms": per_transfer["sum_library_ms"],
            "launches_per_transfer": per_transfer["sum_launches"],
            "ms_per_buffer": per_buffer["sum_ms"],
            "plain_ms_per_buffer": per_buffer["sum_plain_ms"],
            "bound_ms_per_buffer": per_buffer["sum_bound_ms"],
            "library_ms_per_buffer": per_buffer["sum_library_ms"],
            "launches_per_buffer": per_buffer["sum_launches"]}


def backward_row(kind: str, bwd, launches: int):
    """A backward kernel's row of the kernel table (``kind`` dgrad or
    wgrad): its launches in phase 8's 10 training steps (counted on the
    device), its times per generator step from CUDA graphs (the kernel
    through the op, asked for its gradients alone), its plain version's
    (the VJP of the plain forward asked for the same) and F.conv1d's
    autograd backward for the same gradients (cudnn.benchmark off, and
    on beside it)."""
    return {"name": DGRAD_NAME if kind == "dgrad" else WGRAD_NAME,
            "route": "cuda",
            "source": "after_tpu_torch/csrc/snake_conv_backward.cu",
            "replaces": "after_tpu/ops/pallas/fused_conv.py:84",
            "launches": launches,
            "max_abs_err": bwd[f"worst_{kind}_abs"],
            "max_err_ratio": bwd[f"worst_{kind}"],
            "ms": bwd[f"{kind}_ms"], "plain_ms": bwd[f"{kind}_plain_ms"],
            "bound_ms": bwd[f"{kind}_bound_ms"],
            "bound_by": bwd[f"{kind}_bound_by"],
            "library_ms": bwd[f"{kind}_library_ms"],
            "library_benchmark_ms": bwd[f"{kind}_library_benchmark_ms"],
            "unit": "generator step",
            "f64_err": bwd["worst_f64"], "f64_err_plain": bwd["worst_f64_plain"]}


def profile_call(label: str, fn):
    """One call of fn under torch.profiler: wall time, device busy time (the
    union of kernel intervals), idle share, kernel launches and the kernels
    that took the most device time.  Fails if a TF32 kernel ran.  Returns
    (wall ms, busy ms or None, Counter of kernel launches by name, Counter
    of device ms by name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.elapsed_us() > 0]
    if not kernels:
        log(f"profile: {label}: wall {wall_ms:.2f} ms; the profiler recorded no "
            f"device time, so device busy and idle share are not measured")
        return wall_ms, None, Counter(), Counter()
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name = Counter()
    count = Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    log(f"profile: {label} (profiled): wall {wall_ms:.2f} ms, "
        f"{len(kernels)} kernel launches, device busy {busy_us / 1e3:.2f} ms, "
        f"idle share {1 - busy_us / 1e3 / wall_ms:.3f}")
    log(f"profile: top {TOP_KERNELS} kernels by device time (launches, ms, "
        f"name):")
    for name, us in by_name.most_common(TOP_KERNELS):
        log(f"  {count[name]:5d} {us / 1e3:8.3f}  {name[:110]}")
    tf32 = [n for n in by_name if "tf32" in n.lower()
            and not any(k in n for k in PORT_TF32_KERNELS)]
    if tf32:
        fail(f"TF32 kernels ran in {label}: {tf32[:3]}")
    return wall_ms, busy_us / 1e3, count, Counter(
        {k: us / 1e3 for k, us in by_name.items()})


def profile_kept(label: str, fn, expected, bf16: bool = False):
    """Up to PROFILE_TRIES profiles of fn (profile_call), the device's
    launch counts set to 0 before each; fails unless the device counts
    ``expected`` (launches of the kernel, of its split sum; with ``bf16``
    those of the bf16 instantiation) in each.
    Returns (busy ms, the kernel's device ms, the split sum's device ms) of
    the first profile that recorded every launch the device counted, else
    (None, None, None): the profiler may lose a kernel record late in a
    long process, and a profile that did lacks part of the kernel's time."""
    import torch
    from after_tpu_torch.ops.kernels.fused_conv import (device_launches,
                                                        reset_device_launches)

    kernel, split_sum = ((KERNEL16_NAME, SUM16_NAME) if bf16
                         else (KERNEL_NAME, SUM_NAME))
    dtype = torch.bfloat16 if bf16 else torch.float32
    for attempt in range(1, PROFILE_TRIES + 1):
        reset_device_launches(DEVICE)
        _, busy, counts, ms = profile_call(f"{label}, profile {attempt}", fn)
        device = device_launches(DEVICE, dtype)
        if device != tuple(expected):
            fail(f"{label} launched {device}, expected {tuple(expected)}")
        recorded = tuple(kernel_launches(counts, k)
                         for k in (kernel, split_sum))
        log(f"profile: {label}, profile {attempt}: the device counted "
            f"{device[0]} {kernel} and {device[1]} {split_sum} launches, "
            f"the profiler recorded {recorded[0]} and {recorded[1]}")
        if recorded == device:
            kernel_ms = kernel_launches(ms, kernel)
            sum_ms = kernel_launches(ms, split_sum)
            log(f"profile: {label}: {kernel} {kernel_ms:.3f} ms and "
                f"{split_sum} {sum_ms:.3f} ms on the device, busy "
                f"{busy:.2f} ms")
            return busy, kernel_ms, sum_ms
    log(f"profile: {label}: no profile kept all launches in {PROFILE_TRIES}: "
        f"kernel ms and busy not measured")
    return None, None, None


def kernel_launches(counts, name: str) -> int:
    """Launches (or device ms) of the kernels whose name holds ``name``, in
    a profile's Counter."""
    return sum(n for k, n in counts.items() if name in k)


def replay_witness(label: str, counts, ms, per_call: int, sums: int, row,
                   unit: str) -> None:
    """The profiler's count of the kernel's and the split sum's launches in
    one replayed call, against the device's own counts of the main path's
    run (``per_call`` and ``sums`` a call); their device ms, into ``row``."""
    n, n_sum = (kernel_launches(counts, k) for k in (KERNEL_NAME, SUM_NAME))
    t, t_sum = (kernel_launches(ms, k) for k in (KERNEL_NAME, SUM_NAME))
    log(f"profile: {label}: {n} {KERNEL_NAME} launches ({t:.3f} ms) and "
        f"{n_sum} {SUM_NAME} launches ({t_sum:.3f} ms) by the profiler; the "
        f"device counted {per_call} and {sums} a call on the main path")
    if n != per_call or n_sum != sums:
        fail(f"{label}: the profiler and the device's counts differ")
    row[f"launches_per_{unit}_replay"] = n
    row[f"sum_splits_launches_per_{unit}_replay"] = n_sum
    row[f"profiled_ms_per_{unit}_replay"] = t
    row[f"sum_splits_ms_per_{unit}_replay"] = t_sum


def no_host_sync(label: str, fn) -> None:
    """fn under torch.cuda.set_sync_debug_mode("error"): fails on a host
    sync."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        fail(f"{label} synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"no host sync: {label} ran under set_sync_debug_mode('error')")


def agree(label: str, y, ref, limit: float = GRAPH_TOL) -> float:
    """max|y - ref| / max|ref| (tensors or lists of tensors), within
    ``limit``, printed."""
    import torch
    if isinstance(y, (list, tuple)):
        y, ref = torch.cat(list(y), dim=1), torch.cat(list(ref), dim=1)
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"{label}: max abs difference {err:.3e} ({err / scale:.3e} x max|y| "
        f"{scale:.4f}; limit {limit}; bitwise equal: {bool(err == 0)})")
    if not err <= limit * scale:
        fail(f"{label}: differ by {err} > {limit} x {scale}")
    return err / scale


def percentile(values, q: float) -> float:
    """The q-quantile of values (nearest rank)."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def stream_audio(streamer, state, a, b, nb_steps, attributes=None,
                 x0s=None):
    """Stream (a, b) buffer by buffer from ``state`` at ``nb_steps`` with
    guidance_timbre GUIDANCE_TIMBRE, or with ``attributes`` (nb_steps,
    guidance_timbre, guidance_structure) per buffer, from the noise of
    ``x0s`` when given; returns the host times and the outputs of the
    buffers.  Checks every output and that the state's tensors keep their
    addresses."""
    import torch
    from after_tpu_torch.streaming.state import flatten_state

    A = streamer.audio_chunk
    ptrs = {k: t.data_ptr() for k, t in flatten_state(state).items()}
    times, ys = [], []
    for i in range(a.shape[1] // A):
        s = slice(i * A, (i + 1) * A)
        nb, gt, gs = (attributes[i] if attributes is not None
                      else (nb_steps, GUIDANCE_TIMBRE, 1.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, state = streamer.forward(state, a[:, s], b[:, s], nb_steps=nb,
                                    guidance_timbre=gt, guidance_structure=gs,
                                    x0=None if x0s is None else x0s[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if tuple(y.shape) != (a.shape[0], A, 1):
            fail(f"stream buffer {i}: output shape {tuple(y.shape)}")
        if not torch.isfinite(y).all():
            fail(f"stream buffer {i}: non-finite output")
        ys.append(y)
    if ptrs != {k: t.data_ptr() for k, t in flatten_state(state).items()}:
        fail("the stream state's tensors moved between buffers")
    return times, ys


def spread(times) -> str:
    """median / p90 / max of host times, in ms."""
    return (f"{sorted(times)[len(times) // 2] * 1e3:.2f} / "
            f"{percentile(times, 0.9) * 1e3:.2f} / {max(times) * 1e3:.2f}")


def stream_card_vs_cpu(label, card, cpu, n_buffers: int, seed: int):
    """The same two-voice stream on the card and on the CPU, fixed x0 per
    buffer; the largest difference over all buffers against the limit, and
    the same with TF32 allowed.  Returns the card's kernel launches, as the
    device counted them."""
    import numpy as np
    import torch
    from after_tpu_torch.ops.kernels.fused_conv import (device_launches,
                                                        reset_device_launches)
    from after_tpu_torch.utils.device import strict_f32

    rng = np.random.RandomState(seed)
    A = card.audio_chunk
    n = n_buffers * A
    a = 0.1 * rng.randn(2, n, 1).astype(np.float32)
    b = 0.1 * rng.randn(2, n, 1).astype(np.float32)
    x0 = rng.randn(n_buffers, 2, CHUNK,
                   card.cfg.denoiser.n_channels).astype(np.float32)

    def run(streamer, state):
        ys = []
        for i in range(n_buffers):
            s = slice(i * A, (i + 1) * A)
            y, state = streamer.forward(state, a[:, s], b[:, s], 2,
                                        GUIDANCE_TIMBRE, x0=x0[i])
            ys.append(y.cpu())
        return torch.cat(ys, dim=1)

    state = card.init_state(2)
    reset_device_launches()
    y_card = run(card, state)
    launches = device_launches()[0]
    y_cpu = run(cpu, cpu.init_state(2))
    err = (y_card - y_cpu).abs().max().item()
    scale = y_cpu.abs().max().item()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    err_tf32 = (run(card, card.init_state(2)) - y_cpu).abs().max().item()
    strict_f32()
    log(f"streaming card vs CPU, {label}: {n_buffers} buffers of 2 voices, "
        f"max abs err {err:.3e} (with TF32 allowed: {err_tf32:.3e}), max |y| "
        f"{scale:.4f}, tolerance {CARD_VS_CPU_TOL} * max |y| = "
        f"{CARD_VS_CPU_TOL * scale:.3e}; {KERNEL_NAME} launches on the card, "
        f"counted on the device: {launches}")
    if not (torch.isfinite(y_card).all() and err <= CARD_VS_CPU_TOL * scale):
        fail(f"streaming, {label}: card and CPU disagree")
    return launches


def _to_cpu(tree):
    """A copy of a train state's tree on the host (its tensors cloned)."""
    import torch
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def trees_equal(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(trees_equal, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


class _Tee:
    """Standard output that also keeps what is written (a command's own
    lines)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


@contextlib.contextmanager
def step_clock(trainer_cls, sync_every: int = 0):
    """While in the block, ``trainer_cls.fit`` records for each step the
    host ms from the end of the previous step's callback (or fit's start)
    to the start of its own, with the step's kind, graph signature (the
    codec trainer's is its kind) and whether it was the first of its
    signature, and ``load_state_tree`` the train state just after it
    loads: yields the two lists (steps, loaded).  It adds no synchronize
    where the command has none, but for the first step of each signature
    (which compiles or captures and waits for the card anyway): before
    fit and at the start of the callbacks of those steps, of every
    ``sync_every``-th step (where the command saves and validates) and of
    the last step.  So the sum of a run's times is its wall time without
    its callbacks' own work, with the host free to run ahead of the card
    between those points as a user's run does."""
    import torch
    steps, loaded = [], []
    fit, load = trainer_cls.fit, trainer_cls.load_state_tree

    def timed_fit(self, batches, max_steps=None, callback=None, **kw):
        t0, seen = [0.0], set()
        last = max_steps if max_steps is not None else self.tc.max_steps

        def timed(tr, metrics):
            step = tr.step - 1
            kind = tr.step_kind(step)
            sig = ((kind, *tr.step_flags(step)) if hasattr(tr, "step_flags")
                   and kind != "classifier" else (kind,))
            first = sig not in seen
            seen.add(sig)
            if (first or tr.step == last
                    or sync_every and tr.step % sync_every == 0):
                torch.cuda.synchronize()
            steps.append((kind, sig, (time.perf_counter() - t0[0]) * 1e3,
                          first))
            if callback is not None:
                callback(tr, metrics)
            t0[0] = time.perf_counter()

        torch.cuda.synchronize()
        t0[0] = time.perf_counter()
        return fit(self, batches, max_steps, timed, **kw)

    def kept_load(self, tree, *args, **kwargs):
        load(self, tree, *args, **kwargs)
        loaded.append(_to_cpu(self.state_tree()))

    trainer_cls.fit, trainer_cls.load_state_tree = timed_fit, kept_load
    try:
        yield steps, loaded
    finally:
        trainer_cls.fit, trainer_cls.load_state_tree = fit, load


def cli_run(argv, trainer_cls, sync_every: int = 0):
    """``after_tpu_torch.cli.main.main(argv)`` in this process, under
    ``step_clock(trainer_cls, sync_every)``: its exit code, standard
    output, steps and the train state just after a restart's load (None
    without one)."""
    from after_tpu_torch.cli.main import main as cli_main
    tee = _Tee(sys.stdout)
    with step_clock(trainer_cls, sync_every) as (steps, loaded):
        with contextlib.redirect_stdout(tee):
            rc = cli_main(argv)
    return rc, tee.text(), steps, loaded[0] if loaded else None


def step_medians(steps):
    """{kind: (median ms over its steps without the first of each
    signature, or None; steps behind it)}."""
    out = {}
    for kind, _, ms, first in steps:
        out.setdefault(kind, [])
        if not first:
            out[kind].append(ms)
    return {k: (sorted(v)[len(v) // 2] if v else None, len(v))
            for k, v in out.items()}


def wall_ms(steps):
    """A run's wall ms a step: over all its steps, and over the steps after
    the last first step of a signature (None without any), with how many
    those are."""
    total = sum(ms for _, _, ms, _ in steps) / len(steps)
    last = max((i for i, s in enumerate(steps) if s[3]), default=-1)
    tail = steps[last + 1:]
    return (total, sum(ms for _, _, ms, _ in tail) / len(tail)
            if tail else None, len(tail))


def snake_conv_check(label, worst, checked):
    """A forward hook for ``register_module_forward_hook`` that holds each
    ``ConvBlock1d`` output (a launch of the kernel) to the plain version of
    its type on the same input and parameters (inside a bf16 training
    step's ``cast_call`` too): f32 within KERNEL_TOL x max|y|, bf16 within
    BF16_ULPS bf16 ulps of max|y|; fails past it, keeps the worst ratio to
    max|y| in ``worst[0]`` and counts the checks in ``checked[0]``."""
    import torch
    from after_tpu_torch.models.autoencoder import ConvBlock1d
    from after_tpu_torch.ops.kernels.fused_conv import (snake_conv_reference,
                                                        torch_weight)
    from after_tpu_torch.utils.precision import at, promote

    @torch.no_grad()
    def check(mod, args, y):
        if not isinstance(mod, ConvBlock1d):
            return
        h = mod.gn(args[0]) if mod.gn is not None else args[0]
        dtype = torch.promote_types(promote(h, mod.act.alpha),
                                    mod.conv.weight_dtype)
        w_k = mod.conv.kernel_weights(dtype)[0]
        ref = snake_conv_reference(
            h.contiguous().to(dtype), at(mod.act.alpha, dtype),
            at(mod.act.beta, dtype), torch_weight(w_k, h.shape[2]),
            at(mod.conv.bias, dtype), mod.conv.dilation, mod.conv.mode)
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        limit = (BF16_ULPS * bf16_ulp(scale) if dtype == torch.bfloat16
                 else KERNEL_TOL * scale)
        if not err <= limit:
            fail(f"{label}: fused_snake_conv ({dtype}) at {tuple(h.shape)} "
                 f"off its plain version by {err} > {limit}")
        worst[0] = max(worst[0], err / max(scale, 1e-30))
        checked[0] += 1
    return check


def fmt_ms(v) -> str:
    return "none" if v is None else f"{v:.2f}"


def cli_checks(label, rc, out, run, steps_saved, keys, audio, loader=True):
    """A command's run: exit code 0, the checkpoints of ``steps_saved``,
    ``keys`` in metrics.jsonl, the ``audio`` files; returns the loader's
    (ms a batch, dry requests, batches) from its last line (None without
    ``loader``) and the checkpoints' sizes in MiB."""
    import os
    import re
    from after_tpu_torch.utils.checkpoint import available_steps
    if rc != 0:
        fail(f"{label}: exit code {rc}")
    if available_steps(run) != steps_saved:
        fail(f"{label}: checkpoints {available_steps(run)}, expected "
             f"{steps_saved}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        entries = [json.loads(line) for line in f]
    seen = set().union(*entries) if entries else set()
    if not set(keys) <= seen:
        fail(f"{label}: metrics.jsonl lacks {sorted(set(keys) - seen)}")
    if not all(math.isfinite(v) for e in entries for v in e.values()):
        fail(f"{label}: non-finite values in metrics.jsonl")
    have = set(os.listdir(os.path.join(run, "audio")))
    if not set(audio) <= have:
        fail(f"{label}: audio files {sorted(set(audio) - have)} missing")
    sizes = {step: sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                       os.walk(os.path.join(run, f"checkpoint_{step}"))
                       for f in fs) / 2**20 for step in steps_saved}
    if not loader:
        return None, sizes
    m = re.search(r"loader: (\d+) batches built, ([\d.]+) ms a batch; the "
                  r"queue was empty at (\d+) requests", out)
    if m is None:
        fail(f"{label}: no loader line")
    return (float(m.group(2)), int(m.group(3)), int(m.group(1))), sizes


def cli_phase(row) -> None:
    """Phase 12: training from the command line (see the module
    docstring)."""
    import os
    import shutil

    import numpy as np
    import torch
    from after_tpu_torch.autoencoder import AutoencoderTrainer
    from after_tpu_torch.config import load_codec_config
    from after_tpu_torch.dataset import AudioExample, RecordWriter
    from after_tpu_torch.diffusion.trainer import DiffusionTrainer
    from after_tpu_torch.ops.kernels.fused_conv import (
        backward_device_launches, device_launches, fused_snake_conv,
        reset_device_launches)
    from after_tpu_torch.utils.checkpoint import restore_checkpoint
    from torch.nn.modules.module import register_module_forward_hook

    # tensorboard (absent on the card machine) imports protobuf: the phase
    # runs without it, so that the module check below sees the port's own
    sys.modules["torch.utils.tensorboard"] = None
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    wave_db = os.path.join(CLI_DIR, "wavedb")
    z_db = os.path.join(CLI_DIR, "zdb")
    runs = os.path.join(CLI_DIR, "runs")
    ae_run, diff_run = os.path.join(runs, "ae"), os.path.join(runs, "diff")

    def checked_run(label, argv, trainer_cls, sync_every=0):
        """cli_run with the kernel's counts set to 0 just before and read
        just after, and each of its launches held to its plain version:
        (exit code, output, steps, loaded, (wrapper, device) launches,
        worst error ratio)."""
        worst, checked = [0.0], [0]
        gc.collect()
        torch.cuda.empty_cache()
        hook = register_module_forward_hook(
            snake_conv_check(label, worst, checked))
        fused_snake_conv.launches = 0
        reset_device_launches()
        try:
            out = cli_run(argv, trainer_cls, sync_every)
        finally:
            hook.remove()
        launches = (fused_snake_conv.launches, device_launches()[0])
        if launches[0] == 0 or checked[0] != launches[0]:
            fail(f"{label}: {launches} kernel launches, {checked[0]} of them "
                 f"checked")
        return (*out, launches, worst[0])

    # a waveform store, int16 as prepare_dataset stores it
    gen = torch.Generator("cuda").manual_seed(SEED + 12)
    waves = synthetic_audio(gen, CLI_RECORDS, CLI_RECORD_SAMPLES,
                            44100)[..., 0].cpu().numpy()
    with RecordWriter(wave_db) as w:
        for i, x in enumerate(waves):
            e = AudioExample()
            e.put_array("waveform", x, dtype=np.int16, sampling_rate=44100)
            e.put_metadata({"name": f"synthetic_{i}"})
            w.put(f"{i:08d}", e.serialize())

    # the codec: CLI_AE_STEPS steps, timed (its launches counted, not
    # checked: the checks would slow its steps), then a restart for 2 more
    # with every launch held to its plain version
    ae_args = ["train_autoencoder", "--name", "ae", "--db_path", wave_db,
               "--out_path", runs, "--batch_size", "8", "--num_signal",
               "131072", "--override", f"train.warmup_steps={TRAIN_WARMUP}",
               "--override", f"train.steps_save={CLI_AE_EVERY}",
               "--override", f"train.steps_valid={CLI_AE_EVERY}"]
    gc.collect()
    torch.cuda.empty_cache()
    fused_snake_conv.launches = 0
    reset_device_launches()
    rc, out, ae_steps, _ = cli_run(
        ae_args + ["--max_steps", str(CLI_AE_STEPS)], AutoencoderTrainer,
        CLI_AE_EVERY)
    ae_launches = (fused_snake_conv.launches, device_launches()[0])
    # the backward's kernels on the device: dgrad and wgrad once a conv in
    # each generator step (phase 8's schedule), none in the others
    ae_bwd = backward_device_launches()
    want = (sum(1 for k in TRAIN_KINDS[:CLI_AE_STEPS] if k != "disc")
            * row["launches_per_gen_step"])
    if ae_bwd[:2] != (want, want):
        fail(f"train_autoencoder: backward launches {ae_bwd} on the device "
             f"(dgrad, wgrad, {PARTIALS_NAME}), expected {want} dgrad and "
             f"{want} wgrad")
    ae_loader, ae_sizes = cli_checks(
        "train_autoencoder", rc, out, ae_run, [5, 10],
        ["mrstft", "regularisation_loss", "total_loss", "skipped_nonfinite",
         "feature_matching", "adversarial", "val_mrstft",
         "val_total_loss", "steps_per_sec"],
        ["validation_audio_5.wav", "validation_audio_10.wav"])
    if len(ae_steps) != CLI_AE_STEPS or ae_launches[0] == 0:
        fail(f"train_autoencoder ran {len(ae_steps)} steps with "
             f"{ae_launches} kernel launches")
    saved = restore_checkpoint(ae_run, CLI_AE_STEPS)
    rc, out, restart_steps, loaded, ae_checked, ae_worst = checked_run(
        "train_autoencoder --restart",
        ae_args + ["--max_steps", str(CLI_AE_STEPS + 2), "--restart", "0"],
        AutoencoderTrainer)
    cli_checks("train_autoencoder --restart", rc, out, ae_run,
               [5, 10, 12], ["val_mrstft"], ["validation_audio_10.wav"])
    if (loaded is None or loaded["step"] != CLI_AE_STEPS
            or not trees_equal(loaded, saved) or len(restart_steps) != 2):
        fail("train_autoencoder --restart did not resume at step "
             f"{CLI_AE_STEPS} with the saved state")
    ae_meds, ae_wall = step_medians(ae_steps), wall_ms(ae_steps)
    mem = row.get("step_ms_median", {})
    log(f"command line: train_autoencoder, base codec, batch 8 x 131072, "
        f"{CLI_AE_STEPS} steps then a restart at {CLI_AE_STEPS} (weights, "
        f"both optimizer states and the step as saved) for 2 more; wall ms "
        f"a step (a synchronize only at each kind's first step, the "
        f"checkpoints and validation, whose own time is left out, and the "
        f"last step): {ae_wall[0]:.2f} over the {CLI_AE_STEPS}, "
        f"{fmt_ms(ae_wall[1])} over the {ae_wall[2]} after each kind's "
        f"first; median host ms between callbacks without each kind's "
        f"first step: " + ", ".join(
            f"{k} {v:.2f} over {n} (in memory, phase 8, a synchronize a "
            f"step: {fmt_ms(mem.get(k))})"
            for k, (v, n) in ae_meds.items() if v is not None)
        + f"; the loader {ae_loader[0]:.3f} ms a batch over {ae_loader[2]} "
        f"batches, its queue empty at {ae_loader[1]} of {CLI_AE_STEPS} "
        f"requests; {KERNEL_NAME} launches {ae_launches[0]} (device "
        f"{ae_launches[1]}), the backward's on the device {DGRAD_NAME} "
        f"{ae_bwd[0]}, {WGRAD_NAME} {ae_bwd[1]}, {PARTIALS_NAME} "
        f"{ae_bwd[2]}; the restart's {ae_checked[0]} (device "
        f"{ae_checked[1]}) each within {ae_worst:.3e} x max|y| of its plain "
        f"version (limit {KERNEL_TOL}); checkpoints " + ", ".join(
            f"{s}: {v:.1f} MiB" for s, v in ae_sizes.items()))

    # a latent store with the trained codec's latent channels
    channels = load_codec_config(ae_run).z_channels
    latents = synthetic_latents(DIFF_RECORDS, channels, DIFF_RECORD_FRAMES,
                                SEED + 12)
    with RecordWriter(z_db) as w:
        for i, z in enumerate(latents):
            e = AudioExample()
            e.put_array("z", z)
            e.put_metadata({"name": f"synthetic_{i}"})
            w.put(f"{i:08d}", e.serialize())

    # the diffusion model: phase 10's config and longer schedule, validated
    # through the codec run, each kernel launch held to its plain version
    diff_args = (["train", "--name", "diff", "--db_path", z_db,
                  "--out_path", runs, "--config", "base", "--config",
                  "cycle", "--batch_size", str(DIFF_BATCH),
                  "--emb_model_path", ae_run,
                  "--override", f"train.n_signal={DIFF_FRAMES}",
                  "--override", f"train.steps_save={CLI_DIFF_STEPS}",
                  "--override", f"train.steps_valid={CLI_DIFF_STEPS}"]
                 + [a for k, v in {**DIFF_SCHEDULE,
                                   **DIFF_LONG_SCHEDULE}.items()
                    for a in ("--override", f"{k}={v}")])
    rc, out, diff_steps, _, diff_launches, diff_worst = checked_run(
        "train", diff_args + ["--max_steps", str(CLI_DIFF_STEPS)],
        DiffusionTrainer)
    diff_loader, diff_sizes = cli_checks(
        "train", rc, out, diff_run, [CLI_DIFF_STEPS],
        ["diffusion_loss", "loss", "classifier_loss", "cycle_cond",
         "val_diffusion_loss", "val_transfer_margin",
         "val_transfer_margin_audio", "steps_per_sec"],
        [f"{kind}_{i}_{CLI_DIFF_STEPS}.wav" for kind in (
            "true", "reconstruction", "transfer") for i in range(4)])
    if len(diff_steps) != CLI_DIFF_STEPS:
        fail(f"train ran {len(diff_steps)} steps")
    saved = restore_checkpoint(diff_run, CLI_DIFF_STEPS)
    rc, out, restart_steps, loaded = cli_run(
        diff_args + ["--max_steps", str(CLI_DIFF_STEPS + 2), "--restart",
                     "0"], DiffusionTrainer)
    cli_checks("train --restart", rc, out, diff_run,
               [CLI_DIFF_STEPS, CLI_DIFF_STEPS + 2], ["diffusion_loss"], [])
    if (loaded is None or loaded["step"] != CLI_DIFF_STEPS
            or not trees_equal(loaded, saved) or len(restart_steps) != 2):
        fail(f"train --restart did not resume at step {CLI_DIFF_STEPS} with "
             "the saved state")
    # the same command with the latents on the card (--data_on_device):
    # its steps take no host batch and run beside no loader thread
    rc, out, bank_steps, _, bank_launches, bank_worst = checked_run(
        "train --data_on_device", diff_args + [
            "--name", "diff_bank", "--data_on_device", "--max_steps",
            str(CLI_DIFF_STEPS)], DiffusionTrainer)
    cli_checks("train --data_on_device", rc, out,
               os.path.join(runs, "diff_bank"), [CLI_DIFF_STEPS],
               ["diffusion_loss", "val_diffusion_loss"], [], loader=False)
    if len(bank_steps) != CLI_DIFF_STEPS:
        fail(f"train --data_on_device ran {len(bank_steps)} steps")
    diff_meds, diff_wall = step_medians(diff_steps), wall_ms(diff_steps)
    bank_meds, bank_wall = step_medians(bank_steps), wall_ms(bank_steps)
    mem = row.get("diffusion_step_ms_median", {})
    log(f"command line: train, base + cycle, batch {DIFF_BATCH}, n_signal "
        f"{DIFF_FRAMES}, phase 10's longer schedule for {CLI_DIFF_STEPS} "
        f"steps (validation through the codec run), then a restart at "
        f"{CLI_DIFF_STEPS} for 2 more; wall ms a step (a synchronize only "
        f"at each signature's first step, which captures, and the last "
        f"step): {diff_wall[0]:.2f} over the {CLI_DIFF_STEPS}, "
        f"{fmt_ms(diff_wall[1])} over the {diff_wall[2]} after the last "
        f"capture; with --data_on_device {bank_wall[0]:.2f} "
        f"and {fmt_ms(bank_wall[1])} over {bank_wall[2]}; median host ms "
        f"between callbacks without each signature's first step: "
        + ", ".join(f"{k} {fmt_ms(v)} over {n} (--data_on_device "
                    f"{fmt_ms(bank_meds.get(k, (None,))[0])}; in memory, "
                    f"phase 10's long run, a synchronize a step: "
                    f"{fmt_ms(mem.get(k))})"
                    for k, (v, n) in diff_meds.items())
        + f"; the loader {diff_loader[0]:.3f} ms a batch over "
        f"{diff_loader[2]} batches, its queue empty at {diff_loader[1]} of "
        f"{CLI_DIFF_STEPS} requests; validation: {diff_launches[0]} "
        f"{KERNEL_NAME} launches (device {diff_launches[1]}), each within "
        f"{diff_worst:.3e} x max|y| of its plain version (limit "
        f"{KERNEL_TOL}), with --data_on_device {bank_launches[0]} (device "
        f"{bank_launches[1]}) within {bank_worst:.3e}; checkpoints "
        + ", ".join(f"{s}: {v:.1f} MiB" for s, v in diff_sizes.items()))

    no_forbidden_modules("command line")
    row["backward_launches_cli"] = list(ae_bwd)
    row["launches_cli"] = {"train_autoencoder": ae_launches[1],
                           "train_autoencoder_restart": ae_checked[1],
                           "train": diff_launches[1],
                           "train_data_on_device": bank_launches[1]}
    row["cli_max_err_ratio"] = {"train_autoencoder_restart": ae_worst,
                                "train": diff_worst,
                                "train_data_on_device": bank_worst}
    row["cli_wall_ms_per_step"] = {"train_autoencoder": ae_wall[:2],
                                   "train": diff_wall[:2],
                                   "train_data_on_device": bank_wall[:2]}
    row["cli_step_ms_median"] = {
        "train_autoencoder": {k: v for k, (v, _) in ae_meds.items()},
        "train": {k: v for k, (v, _) in diff_meds.items()},
        "train_data_on_device": {k: v for k, (v, _) in bank_meds.items()}}
    row["cli_loader_ms_per_batch"] = {"train_autoencoder": ae_loader[0],
                                      "train": diff_loader[0]}
    row["cli_loader_dry"] = {"train_autoencoder": ae_loader[1],
                             "train": diff_loader[1]}
    gc.collect()
    torch.cuda.empty_cache()


def no_forbidden_modules(label: str) -> None:
    """Fails if a module of FORBIDDEN_MODULES has been imported."""
    bad = sorted(m for m in sys.modules if sys.modules[m] is not None and any(
        m == f or m.startswith(f + ".") for f in FORBIDDEN_MODULES))
    if bad:
        fail(f"{label}: forbidden modules imported: {bad[:10]}")
    log(f"{label}: none of {', '.join(FORBIDDEN_MODULES)} imported")


def _dir_bytes(path: str) -> dict:
    """{file relative to path: bytes} of every file under path."""
    import os
    out = {}
    for root, _, files in os.walk(path):
        for f in sorted(files):
            full = os.path.join(root, f)
            out[os.path.relpath(full, path)] = os.path.getsize(full)
    return out


def _wav_bytes(x, sr: int) -> bytes:
    import io

    import numpy as np
    import scipy.io.wavfile
    buf = io.BytesIO()
    scipy.io.wavfile.write(buf, sr, (np.clip(x, -1, 1) * 32767).astype(
        np.int16))
    return buf.getvalue()


def _request(base: str, path: str, body=None):
    """(status, content type, body, ms) of one request to the server."""
    import urllib.request
    req = urllib.request.Request(base + path, data=body,
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=SERVE_REQUEST_TIMEOUT) as r:
        data = r.read()
        return (r.status, r.headers["Content-Type"], data,
                (time.perf_counter() - t0) * 1e3)


def start_server(art: str) -> dict:
    """Starts ``after-tpu-torch serve --artifact`` in its own process on
    127.0.0.1 and a free port, so that its start (the process, the
    artifact's load and capture) runs beside the untimed checks that
    precede ``serve_phase``; a thread reads its output, and notes when the
    address comes.  The server is stopped with the script in any case."""
    import atexit
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "after_tpu_torch.cli.main", "serve",
         "--artifact", art, "--host", "127.0.0.1", "--port", "0",
         "--device", DEVICE],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    server = {"proc": proc, "art": art, "t0": time.perf_counter(),
              "out": [], "base": None, "ready": threading.Event()}

    def read():
        for line in proc.stdout:
            server["out"].append(line)
            if server["base"] is None and "frontend at http://" in line:
                server["base"] = line.strip().split(" at ")[1]
                server["start_ms"] = (time.perf_counter()
                                      - server["t0"]) * 1e3
                server["ready"].set()
        server["ready"].set()       # the process ended

    server["thread"] = threading.Thread(target=read, daemon=True)
    server["thread"].start()
    atexit.register(_stop_server, proc)
    return server


def _stop_server(proc) -> None:
    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def serve_phase(server: dict, sr: int, audio_chunk: int) -> dict:
    """The server ``start_server`` started: /api/info, then /api/timbre and
    /api/transfer with a SERVE_SECONDS WAV; each must answer 200, the
    transfer a finite WAV of whole buffers.  The server is stopped in any
    case.  Returns each request's ms."""
    import io

    import numpy as np
    import scipy.io.wavfile

    t = np.arange(int(SERVE_SECONDS * sr)) / sr
    rng = np.random.RandomState(SEED + 13)
    wav = _wav_bytes(0.4 * np.sin(2 * np.pi * 220.0 * t)
                     + 0.05 * rng.randn(len(t)), sr)
    proc, art = server["proc"], server["art"]
    ms = {}
    try:
        left = SERVE_START_TIMEOUT - (time.perf_counter() - server["t0"])
        server["ready"].wait(max(left, 0.0))
        base = server["base"]
        if base is None:
            state = ("exited with " + str(proc.poll())
                     if proc.poll() is not None else
                     f"no address within {SERVE_START_TIMEOUT} s")
            fail(f"serve: {state}: " + "".join(server["out"])[-2000:])
        ms["start"] = server["start_ms"]
        pause_background()  # the timed requests, the compiles stopped
        status, ctype, body, ms["info"] = _request(base, "/api/info")
        info = json.loads(body)
        if status != 200 or info.get("artifact") != art:
            fail(f"serve: /api/info answered {status}: {info}")
        status, _, body, ms["timbre"] = _request(base, "/api/timbre", wav)
        if status != 200 or "xy" not in json.loads(body):
            fail(f"serve: /api/timbre answered {status}: {body[:200]}")
        status, ctype, body, ms["transfer"] = _request(
            base, f"/api/transfer?steps={EXPORT_STEPS}&gt={GUIDANCE_TIMBRE}"
            "&seed=1", wav)
        resume_background()
        got_sr, y = scipy.io.wavfile.read(io.BytesIO(body))
        want = -(-len(t) // audio_chunk) * audio_chunk
        if (status != 200 or ctype != "audio/wav" or got_sr != sr
                or len(y) != want or not np.isfinite(y).all()):
            fail(f"serve: /api/transfer answered {status} {ctype}, "
                 f"{len(y)} samples at {got_sr} Hz (expected {want})")
        log(f"serve: after-tpu-torch serve --artifact on {base}: address "
            f"after {ms['start']:.0f} ms (its process starting, the "
            f"artifact loading and capturing, beside the card-vs-CPU and "
            f"codec checks), GET /api/info "
            f"{ms['info']:.1f} ms, POST /api/timbre of {SERVE_SECONDS:g} s "
            f"{ms['timbre']:.1f} ms, POST /api/transfer of {SERVE_SECONDS:g}"
            f" s at nb_steps {EXPORT_STEPS} {ms['transfer']:.1f} ms "
            f"({len(y)} samples, {len(y) // audio_chunk} buffers, finite, "
            f"rms {float(np.sqrt(np.mean((y / 32767.0) ** 2))):.4f}); each "
            f"answered 200")
    finally:
        _stop_server(proc)
    return ms


def export_phase(row, a, b, attrs, on_export=None) -> dict:
    """Phase 13: export and serving (see the module docstring), from the
    runs phase 12 left; ``a`` and ``b`` are phase 6's request and
    ``attrs`` its changing attributes; ``on_export(path)`` is called as
    each artifact is written.  Its timed sections run with the background
    stopped (``background_paused``).  Returns the Python hosts it loaded,
    by artifact path, for phase 15 to play again."""
    import os

    import numpy as np
    import torch
    from after_tpu_torch.cli.export import load_run
    from after_tpu_torch.cli.main import main as cli_main
    from after_tpu_torch.ops.kernels.fused_conv import (device_launches,
                                                        reset_device_launches)
    from after_tpu_torch.streaming import CrossfadeDecoder, Streamer
    from after_tpu_torch.streaming.export import (ExportedCodec,
                                                  ExportedStreamer)
    from after_tpu_torch.utils.checkpoint import restore_checkpoint
    from after_tpu_torch.utils.device import strict_f32
    from after_tpu_torch.utils.graphs import capture_key

    runs = os.path.join(CLI_DIR, "runs")
    ae_run, diff_run = os.path.join(runs, "ae"), os.path.join(runs, "diff")
    art = os.path.join(diff_run, "after.audio.diff")
    art2 = os.path.join(CLI_DIR, "after.audio.diff.voices2")
    codec_art = os.path.join(ae_run, "codec_export")
    per_buffer = row["launches_per_buffer"]
    per_sums = row["sum_splits_launches_per_buffer"]
    export = ["export", "--model_path", diff_run, "--emb_model_path", ae_run,
              "--chunk_size", str(CHUNK), "--nb_steps", str(EXPORT_STEPS),
              "--guidance_timbre", str(GUIDANCE_TIMBRE), "--device", DEVICE]
    seconds = {}
    for label, path, argv in (
            ("export", art, export),
            ("export --batch_size 2", art2,
             export + ["--batch_size", "2", "--out", art2]),
            ("export_autoencoder", codec_art,
             ["export_autoencoder", "--model_path", ae_run, "--chunk_size",
              str(CHUNK), "--device", DEVICE])):
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        if rc != 0:
            fail(f"{label} exited with {rc}")
        if on_export is not None:
            on_export(path)
    sizes = {}
    for label, path in (("artifact", art), ("codec artifact", codec_art)):
        files = _dir_bytes(path)
        sizes[label] = sum(files.values())
        bins = [v for k, v in files.items() if k.endswith(".bin")]
        log(f"export: {label} {path}, {sizes[label] / 2**20:.1f} MiB: "
            + ", ".join(f"{k} {v}" for k, v in files.items()
                        if not k.endswith(".bin"))
            + f", state/leaf_<i>.bin {len(bins)} files {sum(bins)} bytes")
    log("export: seconds (on the card, in this process; beside the "
        "packaging of those before): " + ", ".join(
            f"{k} {v:.2f}" for k, v in seconds.items()))

    # the artifact read back from disk; the live streamer over the same
    # checkpoints (the EMA in the denoiser)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = ExportedStreamer(art, DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    S = int(host.manifest["attributes"]["nb_steps"]["max"])
    captures = host.graphs.captures
    if captures != 3 + S:
        fail(f"the artifact's host captured {captures} graphs, expected "
             f"{3 + S}")
    log(f"artifact: ExportedStreamer load {load_s:.2f} s with the capture of "
        f"its {captures} stage graphs ({host.graphs.capture_seconds:.2f} s "
        f"capturing); torch {torch.__version__}")
    cfg, pipe = load_run(diff_run, ae_run, device=DEVICE)
    # the weights each program holds: the denoiser's once, in step
    n_net = sum(p.numel() for p in pipe.rf.net.parameters())
    held = {k: (sum(t.numel() for t in m.state_dict().values()),
                sum(t.numel() for n, t in m.state_dict().items()
                    if ".net." in f".{n}"))
            for k, m in host.programs.items()}
    log("artifact: weights each program holds (elements, of them the "
        "denoiser's): " + ", ".join(f"{k} {v[0]} ({v[1]})"
                                    for k, v in held.items())
        + f"; the denoiser has {n_net}")
    if held["step"][1] != n_net or any(v[1] for k, v in held.items()
                                       if k != "step"):
        fail("the artifact does not hold the denoiser's weights once, in "
             "its step program")
    streamer = Streamer(cfg, CHUNK, N_FADE, pipeline=pipe)
    A = streamer.audio_chunk
    n_buffers = a.shape[1] // A
    x0s = np.random.RandomState(SEED + 13).randn(
        n_buffers, 1, CHUNK, cfg.denoiser.n_channels).astype(np.float32)

    def host_stream(nb_steps, attributes=None, n=n_buffers):
        times, ys = [], []
        for i in range(n):
            s = slice(i * A, (i + 1) * A)
            nb, gt, gs = (attributes[i] if attributes is not None
                          else (nb_steps, GUIDANCE_TIMBRE, 1.0))
            host.set_attribute("nb_steps", nb)
            host.set_attribute("guidance_timbre", gt)
            host.set_attribute("guidance_structure", gs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = host.call("forward", a[:, s], b[:, s], x0=x0s[i])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if tuple(y.shape) != (1, A, 1) or not torch.isfinite(y).all():
                fail(f"artifact buffer {i}: shape {tuple(y.shape)} or a "
                     "non-finite output")
            ys.append(y)
        return times, ys

    ptrs = [t.data_ptr() for t in host.state]
    pause_background()      # the timed section, the compiles stopped
    host_stream(STREAM_STEPS[-1], n=STREAM_WARMUP)             # warm-up
    stream_audio(streamer, streamer.init_state(1), a[:, :STREAM_WARMUP * A],
                 b[:, :STREAM_WARMUP * A], STREAM_STEPS[-1])
    launches_artifact = sums_artifact = 0
    medians = {}
    for nb in STREAM_STEPS:
        host.reset()
        reset_device_launches()
        times, ys = host_stream(nb)
        launches, sums = device_launches()
        launches_artifact += launches
        sums_artifact += sums
        if launches != per_buffer * n_buffers or sums != per_sums * n_buffers:
            fail(f"artifact, nb_steps {nb}: the device counted {launches} "
                 f"{KERNEL_NAME} and {sums} {SUM_NAME} launches in "
                 f"{n_buffers} buffers, expected {per_buffer} and "
                 f"{per_sums} a buffer")
        live_times, live_ys = stream_audio(streamer, streamer.init_state(1),
                                           a, b, nb, x0s=x0s)
        medians[nb] = (sorted(times)[n_buffers // 2] * 1e3,
                       sorted(live_times)[n_buffers // 2] * 1e3)
        log(f"artifact: nb_steps {nb}, {n_buffers} buffers of {A} samples, "
            f"median / p90 / max ms per buffer {spread(times)}, the live "
            f"streamer's {spread(live_times)}; {KERNEL_NAME} and {SUM_NAME} "
            f"launches counted on the device {launches / n_buffers:g} and "
            f"{sums / n_buffers:g} a buffer")
        agree(f"artifact nb_steps {nb}: artifact vs live streamer, "
              f"{n_buffers} buffers", ys, live_ys)
    n = len(attrs)
    host.reset()
    reset_device_launches()
    times, ys = host_stream(None, attrs, n)
    changing = device_launches()[0]
    live_times, live_ys = stream_audio(streamer, streamer.init_state(1),
                                       a[:, :n * A], b[:, :n * A], None,
                                       attributes=attrs, x0s=x0s)
    if changing != per_buffer * n:
        fail(f"artifact: the device counted {changing} {KERNEL_NAME} "
             f"launches in {n} buffers with changing attributes")
    if host.graphs.captures != captures:
        fail("the artifact's host captured after its load")
    if ptrs != [t.data_ptr() for t in host.state]:
        fail("the artifact's state tensors moved between buffers")
    log(f"artifact: {n} buffers with nb_steps 1-{S} and both guidances "
        f"changing every buffer: median / p90 / max ms {spread(times)}, the "
        f"live streamer's {spread(live_times)}; no capture after the load; "
        f"{changing} {KERNEL_NAME} launches counted on the device")
    agree(f"artifact with changing attributes: artifact vs live streamer, "
          f"{n} buffers", ys, live_ys)
    one = (a[:, :A], b[:, :A])
    host.set_attribute("nb_steps", STREAM_STEPS[-1])
    host.call("forward", *one)
    # the profiler may lose a kernel record late in this process (95 of
    # the device's 96 in three of four runs)
    busy, kernel_ms, _ = profile_kept(
        f"one artifact buffer at nb_steps {STREAM_STEPS[-1]}",
        lambda: host.call("forward", *one),
        (per_buffer, per_sums))
    row["profiled_ms_per_artifact_buffer"] = kernel_ms
    # what the live streamer's host computes at every call and the
    # artifact's host does not (ROADMAP B4)
    t0 = time.perf_counter()
    for _ in range(100):
        capture_key(streamer.codec, streamer.rf)
    key_ms = (time.perf_counter() - t0) * 10
    log(f"artifact: capture_key of the live streamer's modules, "
        f"{key_ms:.3f} ms a call (host, mean of 100)")
    row["live_capture_key_ms"] = key_ms
    resume_background()
    # the server starts beside the untimed checks to come
    server = start_server(art)

    # the kernel against its plain version on this path: the two-voice
    # artifact on the card and moved to the CPU, where the op is the plain
    # version
    gc.collect()
    rng = np.random.RandomState(SEED + 14)
    m = STREAM_VS_CPU_BUFFERS * A
    a2 = 0.1 * rng.randn(2, m, 1).astype(np.float32)
    b2 = 0.1 * rng.randn(2, m, 1).astype(np.float32)
    x2 = rng.randn(STREAM_VS_CPU_BUFFERS, 2, CHUNK,
                   cfg.denoiser.n_channels).astype(np.float32)

    def voices(h):
        h.set_attribute("nb_steps", 2)
        ys = [h.call("forward", a2[:, i * A:(i + 1) * A],
                     b2[:, i * A:(i + 1) * A], x0=x2[i]).cpu()
              for i in range(STREAM_VS_CPU_BUFFERS)]
        return torch.cat(ys, dim=1)

    card = ExportedStreamer(art2, DEVICE)
    reset_device_launches()
    y_card = voices(card)
    voice_launches = device_launches()[0]
    y_cpu = voices(ExportedStreamer(art2, device="cpu"))
    err = (y_card - y_cpu).abs().max().item()
    scale = y_cpu.abs().max().item()
    # the same host op by op with TF32 allowed (its graphs keep the
    # switches of their capture), from the initial state again
    card.reset()
    card.eager = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    err_tf32 = (voices(card) - y_cpu).abs().max().item()
    strict_f32()
    card.eager = False
    log(f"artifact card vs CPU: {STREAM_VS_CPU_BUFFERS} buffers of 2 voices "
        f"(the artifact of --batch_size 2, moved to the CPU with "
        f"move_to_device_pass), max abs err {err:.3e} (op by op with TF32 "
        f"allowed: {err_tf32:.3e}), max |y| {scale:.4f}, tolerance "
        f"{CARD_VS_CPU_TOL} "
        f"* max |y| = {CARD_VS_CPU_TOL * scale:.3e}; {KERNEL_NAME} launches "
        f"on the card, counted on the device: {voice_launches}")
    if not (torch.isfinite(y_card).all() and err <= CARD_VS_CPU_TOL * scale):
        fail("artifact: card and CPU disagree")
    if voice_launches != per_buffer * STREAM_VS_CPU_BUFFERS:
        fail(f"artifact: the two-voice buffers launched {voice_launches} "
             f"kernels")

    # the codec-only artifact against the live crossfade codec
    codec = ExportedCodec(codec_art, DEVICE)
    live = CrossfadeDecoder(cfg.autoencoder, n_fade=N_FADE, chunk_size=CHUNK)
    tree = restore_checkpoint(ae_run)
    live.codec.load_state_dict(tree.get("codec_vars", tree))
    live.codec.to(DEVICE).eval()
    enc, dec = live.init_encode_state(1), live.init_state(1)
    reset_device_launches()
    ys = [codec.forward(a[:, i * A:(i + 1) * A]) for i in range(n_buffers)]
    codec_launches = device_launches()[0]
    with torch.no_grad():
        live_ys = [live.decode(dec, live.encode(enc, torch.from_numpy(
            a[:, i * A:(i + 1) * A]).to(DEVICE))) for i in range(n_buffers)]
    if codec_launches != 2 * per_buffer // 3 * n_buffers:
        fail(f"codec artifact: the device counted {codec_launches} "
             f"{KERNEL_NAME} launches in {n_buffers} forwards")
    log(f"codec artifact: {n_buffers} forwards (encode then decode, its "
        f"own state), {codec_launches // n_buffers} {KERNEL_NAME} launches "
        f"a forward, counted on the device")
    agree(f"codec artifact forward vs the live crossfade codec, {n_buffers} "
          f"buffers", ys, live_ys)
    del streamer, pipe
    gc.collect()
    torch.cuda.empty_cache()

    serve_ms = serve_phase(server, cfg.sr, A)
    no_forbidden_modules("export and serving")
    row["launches_artifact"] = launches_artifact
    row["launches_per_artifact_buffer"] = launches_artifact // (
        n_buffers * len(STREAM_STEPS))
    row["artifact_buffer_ms_median"] = {k: v[0] for k, v in medians.items()}
    row["artifact_live_buffer_ms_median"] = {k: v[1]
                                             for k, v in medians.items()}
    row["artifact_busy_ms"] = busy
    row["export_seconds"] = seconds
    row["artifact_bytes"] = sizes
    row["artifact_load_seconds"] = load_s
    row["artifact_card_vs_cpu"] = err / scale
    row["serve_ms"] = serve_ms
    return {art: host, art2: card, codec_art: codec}


NATIVE_DIR = "build/native_phase"   # phase 15's WAVs, noise and outputs
NATIVE_TIMEOUT = 600         # seconds a host run may take


def _write_f32_wav(path: str, x, sr: int) -> None:
    import struct

    import numpy as np
    data = np.asarray(x, "<f4").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
                + struct.pack("<IHHIIHH", 16, 3, 1, sr, sr * 4, 4, 32)
                + b"data" + struct.pack("<I", len(data)) + data)


def _read_f32_wav(path: str):
    import numpy as np
    with open(path, "rb") as f:
        return np.frombuffer(f.read()[44:], "<f4").copy()


def _host_run(label, host, args, env=None, stdin=None, device=DEVICE):
    """One run of the native host: its stdout, and its stderr's numbers
    (ms a buffer, the launches the device counted)."""
    return _host_result(label, *_host_proc(host, args, env, stdin, device))


def _host_runs_at_once(runs: dict) -> dict:
    """Several untimed runs of the native host at once, each a process:
    ``runs`` maps a label to ``_host_run``'s (host, args, env, stdin,
    device); returns ``_host_run``'s result by label."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(runs)) as pool:
        done = {label: pool.submit(_host_proc, *run)
                for label, run in runs.items()}
    return {label: _host_result(label, *f.result())
            for label, f in done.items()}


def _host_proc(host, args, env=None, stdin=None, device=DEVICE):
    import os
    cmd = [str(host), *map(str, args), "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, input=stdin, capture_output=True,
                          env=dict(os.environ, **(env or {})),
                          timeout=NATIVE_TIMEOUT)
    return proc, time.perf_counter() - t0


def _host_result(label, proc, seconds):
    err = proc.stderr.decode(errors="replace")
    if proc.returncode != 0:
        fail(f"native host, {label}: exit {proc.returncode}:\n{err[-3000:]}")
    info = {"seconds": seconds, "stderr": err}
    for line in err.splitlines():
        if line.startswith("[stream_host] buffer ms: "):
            info["ms"] = [float(v) / 1e3 for v in
                          line.split(": ", 1)[1].split(",")]
        elif line.startswith("[stream_host] launches counted on the "
                             "device: "):
            words = line.split()
            info["launches"] = (int(words[7].rstrip(",")), int(words[9]))
        elif line.startswith("[stream_host] load "):
            info["load_s"] = float(line.split()[2])
    return proc.stdout, info


def path_bound(path, batch: int = 1):
    """(ms, "bytes" or "operations"): the least time the card takes for the
    kernel's launches over ``path`` ((ConvBlock1d, T) pairs) at ``batch``,
    each launch the larger of its operations (3xTF32 at PEAK_TF32_FLOPS)
    and its bytes (inputs read once, output written once, at PEAK_BYTES),
    as phase 3 counts them."""
    ms = ops_ms = bytes_ms = 0.0
    for block, T in path:
        k, d, C, O, T, mode = block_shape(block, T)
        flops = 2.0 * k * C * O * T * batch
        nbytes = 4.0 * (batch * T * C + 2 * C + O * C * k + O
                        + batch * T * O)
        ops_ms += 1e3 * 3 * flops / PEAK_TF32_FLOPS
        bytes_ms += 1e3 * nbytes / PEAK_BYTES
        ms += 1e3 * max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES)
    return ms, "operations" if ops_ms >= bytes_ms else "bytes"


_BACKGROUND = []     # process groups started beside the phases
_PAUSED = [0.0, 0.0, []]   # seconds they were stopped for timed
                            # sections; the pause under way


def _signal_background(procs, sig) -> None:
    import os
    for proc in procs:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, sig)


def _stop_background() -> None:
    """Stops every process group started beside the phases that still
    runs (a failing phase exits while phase 15's packages compile)."""
    import signal
    live = [proc for proc in _BACKGROUND if proc.poll() is None]
    _signal_background(live, signal.SIGKILL)
    for proc in live:
        proc.wait()


def pause_background() -> None:
    """Stops the process groups started beside the phases (SIGSTOP) for a
    timed section, so that their compiles share neither the CPU nor the
    card with what is timed; ``resume_background`` continues them (a
    failing section exits, and ``_stop_background`` kills them)."""
    import signal
    _PAUSED[1:] = [time.perf_counter(), [proc for proc in _BACKGROUND
                                         if proc.poll() is None]]
    _signal_background(_PAUSED[2], signal.SIGSTOP)


def resume_background() -> None:
    import signal
    t0, stopped = _PAUSED[1:]
    _signal_background(stopped, signal.SIGCONT)
    if stopped:
        _PAUSED[0] += time.perf_counter() - t0


def start_packaging() -> dict:
    """Phase 15's first half, run beside the rest of phases 13 and 16: the
    native host's build (a thread, started here) and the stages' packages
    (``package_in_background``, as each artifact is exported): the main
    artifact, the codec artifact and the two-voice one for the card, the
    two-voice one also for the CPU.  A job is a process group (its stages a
    process each, all at once) at the lowest CPU priority, killed with the
    script, and stopped while a section is timed (``background_paused``)."""
    import atexit
    import threading

    from after_tpu_torch.ops.kernels.build import native_host

    built = {}

    def build():
        t0 = time.perf_counter()
        built["host"] = native_host()
        built["seconds"] = time.perf_counter() - t0

    atexit.register(_stop_background)
    build_thread = threading.Thread(target=build)
    build_thread.start()
    return {"built": built, "thread": build_thread, "jobs": [], "procs": [],
            "t0": time.perf_counter()}


def package_in_background(started: dict, path: str, *devices: str) -> None:
    """Starts the packaging of the artifact at ``path`` for each of
    ``devices``, a job each (see ``start_packaging``)."""
    import os

    from after_tpu_torch.streaming.native import PARENT_ENV

    # each job dies with the script, however it dies (PR_SET_PDEATHSIG, as
    # its stage processes die with it), at the lowest CPU priority, which
    # the processes it starts inherit
    env = dict(os.environ, **{PARENT_ENV: str(os.getpid())})
    # a job's output goes to files (NATIVE_JOB_LOGS), which no one must
    # read while it runs: a pipe left unread until phase 15 would fill and
    # stop the job writing to it
    os.makedirs(NATIVE_JOB_LOGS, exist_ok=True)
    for dev in devices:
        log_path = os.path.join(NATIVE_JOB_LOGS, f"{os.path.basename(
            path.rstrip('/'))}.{dev}")
        with open(log_path + ".out", "w") as out, \
                open(log_path + ".err", "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "after_tpu_torch.streaming.native",
                 path, "--device", dev],
                stdout=out, stderr=err, text=True, start_new_session=True,
                env=env)
        os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
        _BACKGROUND.append(proc)
        started["jobs"].append((path, dev))
        started["procs"].append((proc, log_path))
    log(f"native: packaging {path} for {', '.join(devices)} started "
        f"(niced) beside the phases to come, "
        f"{time.perf_counter() - started['t0']:.1f} s into phase 13")


def native_phase(row, a, b, attrs, started, hosts=None) -> None:
    """Phase 15: the native streaming host on phase 13's artifacts (see the
    module docstring).  The Python hosts' references are computed first,
    while the packages that ``start_packaging`` started (``started``)
    still compile, on the hosts phase 13 loaded (``hosts``, by artifact
    path, each reset to its initial state; loaded here where absent);
    then the host runs, once the build and the packages are done.  ``a``
    and ``b`` are phase 6's request and ``attrs`` its changing
    attributes."""
    import os

    import numpy as np
    import torch
    from after_tpu_torch.streaming.export import (ExportedCodec,
                                                  ExportedStreamer)
    from after_tpu_torch.streaming.native import exit_reason

    runs = os.path.join(CLI_DIR, "runs")
    art = os.path.join(runs, "diff", "after.audio.diff")
    art2 = os.path.join(CLI_DIR, "after.audio.diff.voices2")
    codec_art = os.path.join(runs, "ae", "codec_export")
    per_buffer = row["launches_per_buffer"]
    per_sums = row["sum_splits_launches_per_buffer"]
    os.makedirs(NATIVE_DIR, exist_ok=True)

    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    A, T = manifest["audio_chunk"], manifest["chunk_size"]
    sr = manifest["sr"]
    C = manifest["config"]["denoiser"]["n_channels"]
    S = int(manifest["attributes"]["nb_steps"]["max"])
    n_buffers = a.shape[1] // A
    x0s = np.random.RandomState(SEED + 13).randn(
        n_buffers, 1, T, C).astype(np.float32)
    d = NATIVE_DIR
    _write_f32_wav(f"{d}/s.wav", a[0, :, 0], sr)
    _write_f32_wav(f"{d}/t.wav", b[0, :, 0], sr)
    x0s.tofile(f"{d}/x0.f32")

    hosts = dict(hosts or {})

    def loaded(path, cls):
        """The Python host of ``path`` from its initial state, with the
        manifest's default attributes."""
        h = hosts.pop(path, None) or cls(path, DEVICE)
        h.reset()
        if cls is ExportedStreamer:
            h.attributes = {k: v["default"]
                            for k, v in h.manifest["attributes"].items()}
        return h

    # the Python host on the same artifact, inputs and noise, while the
    # packages compile (stopped while it is timed)
    py = loaded(art, ExportedStreamer)

    def py_stream(nb_steps, attributes=None, n=n_buffers):
        times, ys = [], []
        for i in range(n):
            nb, gt, gs = (attributes[i] if attributes is not None
                          else (nb_steps, GUIDANCE_TIMBRE, 1.0))
            py.set_attribute("nb_steps", nb)
            py.set_attribute("guidance_timbre", gt)
            py.set_attribute("guidance_structure", gs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = py.call("forward", a[:, i * A:(i + 1) * A],
                        b[:, i * A:(i + 1) * A], x0=x0s[i]).cpu()
            times.append(time.perf_counter() - t)
            ys.append(y.numpy().ravel())
        return times, np.concatenate(ys)

    pause_background()      # the timed section, the compiles stopped
    py_stream(STREAM_STEPS[-1], n=STREAM_WARMUP)                # warm-up
    py_refs = {}
    for nb in STREAM_STEPS:
        py.reset()
        py_refs[nb] = py_stream(nb)
    n = len(attrs)
    py.reset()
    py_refs["changing"] = py_stream(None, attrs, n)
    resume_background()
    del py
    gc.collect()
    torch.cuda.empty_cache()

    # the two voices' inputs and the Python host's output on them
    rng = np.random.RandomState(SEED + 14)
    m = STREAM_VS_CPU_BUFFERS * A
    a2 = 0.1 * rng.randn(2, m, 1).astype(np.float32)
    b2 = 0.1 * rng.randn(2, m, 1).astype(np.float32)
    x2 = rng.randn(STREAM_VS_CPU_BUFFERS, 2, T, C).astype(np.float32)
    x2.tofile(f"{d}/x2.f32")
    files = {}
    for name, x in (("s", a2), ("t", b2)):
        files[name] = ",".join(f"{d}/{name}2_{v}.wav" for v in range(2))
        for v in range(2):
            _write_f32_wav(f"{d}/{name}2_{v}.wav", x[v, :, 0], sr)
    voices = loaded(art2, ExportedStreamer)
    voices.set_attribute("nb_steps", 2)
    voices.set_attribute("guidance_timbre", GUIDANCE_TIMBRE)
    voices_ref = np.concatenate([voices.call(
        "forward", a2[:, i * A:(i + 1) * A], b2[:, i * A:(i + 1) * A],
        x0=x2[i]).cpu().numpy()[..., 0]
        for i in range(STREAM_VS_CPU_BUFFERS)], axis=1)
    del voices

    # the codec artifact's forward through ExportedCodec
    codec = loaded(codec_art, ExportedCodec)
    codec_ref = np.concatenate([codec.forward(a[:, i * A:(i + 1) * A]).cpu()
                                .numpy().ravel() for i in range(n_buffers)])
    del codec
    gc.collect()
    torch.cuda.empty_cache()

    built, t0 = started["built"], started["t0"]
    t_wait = time.perf_counter()
    packaging, job_s = {}, {}
    for (path, dev), (proc, log_path) in zip(started["jobs"],
                                             started["procs"]):
        proc.wait()
        with open(log_path + ".out") as f:
            out = f.read()
        with open(log_path + ".err") as f:
            err = f.read()
        if proc.returncode != 0:
            fail(f"packaging {path} for {dev} failed "
                 f"({exit_reason(proc.returncode)}; its output in "
                 f"{log_path}.out and .err):\n{err[-3000:]}\n{out[-1000:]}")
        name = f"{os.path.basename(path)} ({dev})"
        packaging[name] = json.loads(out.strip().splitlines()[-1])
        job_s[name] = time.perf_counter() - t0
    started["thread"].join()
    if "host" not in built:
        fail("the native host did not build (see the error above)")
    host = built["host"]
    wall = time.perf_counter() - t0
    log(f"native: card {card_line()}; host built in {built['seconds']:.2f} "
        f"s ({host.name}, with nvcc's kernel); packages (AOTInductor, "
        f"a job's stages at once, {len(packaging)} jobs, each started as "
        f"its artifact was exported, niced, beside phases 13 and 16-18 and "
        f"stopped for {_PAUSED[0]:.2f} s of their timed sections; "
        f"{wall:.2f} s wall from phase 13's start, of it "
        f"{time.perf_counter() - t_wait:.2f} s waited for after the "
        f"phases before and the Python hosts' references): "
        + "; ".join(
            f"{k}: " + ", ".join(f"{s} {v:.1f} s" for s, v in d.items())
            + f" (done at {job_s[k]:.1f} s)" for k, d in packaging.items()))
    ldd = subprocess.run(["ldd", str(host)], capture_output=True,
                         text=True).stdout
    if "libpython" in ldd or "libtorch_cuda" not in ldd:
        fail(f"the native host links {ldd}")

    def check(label, y, ref, limit=CARD_VS_CPU_TOL):
        if y.shape != ref.shape or not np.isfinite(y).all():
            fail(f"native host, {label}: shape {y.shape} or non-finite")
        err = float(np.abs(y - ref).max())
        scale = float(np.abs(ref).max())
        log(f"native: {label}: max abs err {err:.3e}, max |y| {scale:.4f}, "
            f"tolerance {limit} * max |y| = {limit * scale:.3e}")
        if not err <= limit * scale:
            fail(f"native host, {label}: outside the tolerance")
        return err / scale

    def launches(label, info, n):
        got = info.get("launches")
        if got != (per_buffer * n, per_sums * n):
            fail(f"native host, {label}: the device counted {got} "
                 f"{KERNEL_NAME} and {SUM_NAME} launches in {n} buffers, "
                 f"expected {per_buffer} and {per_sums} a buffer")
        return got[0]

    total = 0
    medians, readings = {}, {}
    for nb in STREAM_STEPS:
        py_times, ref = py_refs[nb]
        _, info = _host_run(f"nb_steps {nb}", host, [
            art, f"{d}/s.wav", f"{d}/t.wav", f"{d}/o{nb}.wav", n_buffers,
            nb, GUIDANCE_TIMBRE, 1.0, "--x0", f"{d}/x0.f32"],
            env={"AFTER_NATIVE_PIPELINE": "1"})
        y = _read_f32_wav(f"{d}/o{nb}.wav")
        total += launches(f"nb_steps {nb}", info, n_buffers)
        medians[nb] = (sorted(info["ms"])[n_buffers // 2] * 1e3,
                       sorted(py_times)[n_buffers // 2] * 1e3)
        log(f"native: nb_steps {nb}, {n_buffers} buffers of {A} samples "
            f"(readback depth 1): median / p90 / max ms a buffer "
            f"{spread(info['ms'])}, the Python host's {spread(py_times)}; "
            f"load {info['load_s']:.2f} s (3 + {S} graphs captured), run "
            f"{info['seconds']:.2f} s; {KERNEL_NAME} and {SUM_NAME} "
            f"launches counted on the device "
            f"{info['launches'][0] / n_buffers:g} and "
            f"{info['launches'][1] / n_buffers:g} a buffer")
        readings[f"nb_steps {nb}"] = check(
            f"nb_steps {nb}, host vs Python host, {n_buffers} buffers", y,
            ref)
        if nb == STREAM_STEPS[-1]:
            y_file = y

    # nb_steps and both guidances changing every buffer, by AFTER_NATIVE_CTRL
    with open(f"{d}/ctrl.txt", "w") as f:
        for i, (nb, gt, gs) in enumerate(attrs):
            f.write(f"@{i} nb_steps {nb}\n@{i} guidance_timbre {gt!r}\n"
                    f"@{i} guidance_structure {gs!r}\n")
    py_times, ref = py_refs["changing"]
    _, info = _host_run("changing attributes", host, [
        art, f"{d}/s.wav", f"{d}/t.wav", f"{d}/oc.wav", n, 1,
        "--x0", f"{d}/x0.f32"], env={"AFTER_NATIVE_CTRL": f"{d}/ctrl.txt",
                                     "AFTER_NATIVE_PIPELINE": "1"})
    total += launches("changing attributes", info, n)
    log(f"native: {n} buffers with nb_steps 1-{S} and both guidances "
        f"changing every buffer (AFTER_NATIVE_CTRL): median / p90 / max ms "
        f"{spread(info['ms'])} (readback depth 1), the Python host's "
        f"{spread(py_times)}")
    readings["changing"] = check(
        f"changing attributes, host vs Python host, {n} buffers",
        _read_f32_wav(f"{d}/oc.wav"), ref)

    # the untimed runs at once: live, interleaved 2-channel f32 in through
    # a pipe, mono f32 out; the two voices on the card and on the CPU
    frames = np.stack([a[0, :, 0], b[0, :, 0]], axis=1).astype("<f4")
    untimed = {"--pcm": (host, [
        art, "--pcm", STREAM_STEPS[-1], GUIDANCE_TIMBRE, 1.0,
        "--x0", f"{d}/x0.f32"], None, frames.tobytes())}
    for dev in ("cuda", "cpu"):
        outs = ",".join(f"{d}/o2_{dev}_{v}.wav" for v in range(2))
        untimed[f"two voices on {dev}"] = (host, [
            art2, files["s"], files["t"], outs, STREAM_VS_CPU_BUFFERS, 2,
            GUIDANCE_TIMBRE, 1.0, "--x0", f"{d}/x2.f32"], None, None, dev)
    results = _host_runs_at_once(untimed)
    out, info = results["--pcm"]
    total += launches("--pcm", info, n_buffers)
    y = np.frombuffer(out, "<f4")
    readings["pcm"] = check(f"--pcm through pipes vs file mode, nb_steps "
                            f"{STREAM_STEPS[-1]}", y, y_file, GRAPH_TOL)

    # the two voices: the host on the card against the Python host and
    # against the same host on the CPU (the op's plain version there)
    ys = {}
    for dev in ("cuda", "cpu"):
        _, info = results[f"two voices on {dev}"]
        ys[dev] = np.stack([_read_f32_wav(f"{d}/o2_{dev}_{v}.wav")
                            for v in range(2)])
        if dev == "cuda":
            total += launches("two voices", info, STREAM_VS_CPU_BUFFERS)
    readings["voices"] = check(
        f"two voices, host vs Python host, {STREAM_VS_CPU_BUFFERS} buffers",
        ys["cuda"], voices_ref)
    readings["card_vs_cpu"] = check(
        f"two voices, host on the card vs the host on the CPU, "
        f"{STREAM_VS_CPU_BUFFERS} buffers", ys["cuda"], ys["cpu"])

    # the codec-only artifact: its forward, buffer by buffer
    _, info = _host_run("codec artifact", host, [
        codec_art, f"{d}/s.wav", f"{d}/oa.wav", n_buffers])
    codec_launches = info["launches"][0]
    if codec_launches != 2 * per_buffer // 3 * n_buffers:
        fail(f"native host, codec artifact: the device counted "
             f"{codec_launches} {KERNEL_NAME} launches in {n_buffers} "
             "forwards")
    total += codec_launches
    readings["codec"] = check(
        f"codec artifact forward, host vs ExportedCodec, {n_buffers} buffers",
        _read_f32_wav(f"{d}/oa.wav"), codec_ref)
    log(f"native: codec artifact, {n_buffers} forwards, median / p90 / max "
        f"ms {spread(info['ms'])}, {codec_launches // n_buffers} "
        f"{KERNEL_NAME} launches a forward, counted on the device")
    log(f"native: card {card_line()}")
    # the codec artifact forward's bound: one encode and one decode of a
    # crossfade window, at the codec run's shapes
    from after_tpu_torch.config import load_codec_config
    from after_tpu_torch.models.autoencoder import AudioCodec
    ccfg = load_codec_config(os.path.join(runs, "ae"))
    enc_w, dec_w = codec_conv_blocks(AudioCodec(ccfg),
                                     (N_FADE + CHUNK) * ccfg.ratio)
    codec_bound, codec_by = path_bound(enc_w + dec_w)
    log(f"native: the kernel's bound a codec artifact forward "
        f"({len(enc_w + dec_w)} launches): {codec_bound:.4f} ms ({codec_by}"
        f"), a host buffer's ({per_buffer} launches) "
        f"{row['bound_ms_per_buffer']:.4f} ms")
    row["bound_ms_per_codec_artifact_forward"] = codec_bound
    row["launches_native_host"] = total
    row["launches_per_native_buffer"] = per_buffer
    row["native_buffer_ms_median"] = {k: v[0] for k, v in medians.items()}
    row["native_python_buffer_ms_median"] = {k: v[1]
                                             for k, v in medians.items()}
    row["native_build_seconds"] = built["seconds"]
    row["native_package_seconds"] = packaging
    row["native_readings"] = readings


class _Timer:
    """Wraps ``owner.name`` (a function or method) so that each call's host
    ms, synchronized before and after on the card where ``sync``, lands in
    ``self.ms``; ``restore`` puts the original back."""

    def __init__(self, owner, name: str, sync: bool = False):
        import torch
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.own = name in vars(owner)       # not inherited
        self.ms = []
        fn, ms = self.fn, self.ms

        def timed(*args, **kwargs):
            if sync and DEVICE == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync and DEVICE == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(owner, name, timed)

    def restore(self) -> None:
        if self.own:
            setattr(self.owner, self.name, self.fn)
        else:
            delattr(self.owner, self.name)

    def median(self):
        return sorted(self.ms)[len(self.ms) // 2] if self.ms else None


def _corpus(root: str, sr: int, n: int):
    """The synthetic corpus of phase 14 under ``root``: WAV files of a few
    sinusoids and noise from the seed, in chunks of ``n`` samples; returns
    (the main corpus directory, the MIDI corpus directory, the chunks the
    main run keeps)."""
    import os

    import numpy as np
    from after_tpu_torch.dataset.audio import save_wav
    from after_tpu_torch.dataset.midi import MidiFile, Note

    rng = np.random.RandomState(SEED + 14)

    def sound(length):
        t = np.arange(length) / sr
        x = sum(rng.uniform(0.05, 0.2) * np.sin(
            2 * np.pi * rng.uniform(60.0, 2000.0) * t
            * (1 + rng.uniform(-0.05, 0.05) * t)) for _ in range(4))
        # a pulse every half second, so that the beat trackers find beats
        pulse = (np.sin(2 * np.pi * 2.0 * t) > 0.98) * rng.uniform(0.3, 0.5)
        return (x + pulse + 0.01 * rng.randn(length)).astype(np.float32)

    main, midi = os.path.join(root, "corpus"), os.path.join(root, "midi")
    os.makedirs(main)
    os.makedirs(midi)
    silent = sound(2 * n)
    silent[n:] = 0.0                             # --cut_silences drops it
    files = {"three_chunks": sound(3 * n),
             "padded_tail": sound(3 * n + n // 2),   # a padded fourth chunk
             "short": sound(PREP_SHORT_SAMPLES),     # tiled to one chunk
             "half_silent": silent}
    for name, x in files.items():
        save_wav(os.path.join(main, f"{name}.wav"), x, sr)
    save_wav(os.path.join(midi, "with_midi.wav"), sound(n), sr)
    MidiFile(notes=[Note(60 + i, 90, 0.5 * i, 0.5 * i + 0.4)
                    for i in range(int(n / sr / 0.5))]).save(
        os.path.join(midi, "with_midi.mid"))
    return main, midi, 3 + 4 + 1 + 1


def dataset_phase(row) -> None:
    """Phase 14: dataset preparation (see the module docstring), with phase
    12's codec run."""
    import os
    import shutil

    import numpy as np
    import torch
    from after_tpu_torch.cli import prepare_dataset as prep
    from after_tpu_torch.cli.main import main as cli_main
    from after_tpu_torch.cli.train import make_codec_coder
    from after_tpu_torch.config import load_codec_config
    from after_tpu_torch.dataset import AudioExample, RecordReader
    from after_tpu_torch.dataset import midi as midi_io
    from after_tpu_torch.dataset.audio import load_wav, normalize_signal
    from after_tpu_torch.dataset.basic_pitch import (BasicPitch,
                                                     reference_state_dict)
    from after_tpu_torch.dataset import beat_tracker as bt
    from after_tpu_torch.diffusion.trainer import DiffusionTrainer
    from after_tpu_torch.models.autoencoder import AudioCodec
    from after_tpu_torch.ops.kernels.fused_conv import (device_launches,
                                                        reset_device_launches)
    from after_tpu_torch.utils.checkpoint import restore_checkpoint
    from after_tpu_torch.utils.device import strict_f32

    sys.modules["torch.utils.tensorboard"] = None
    root = os.path.join(CLI_DIR, "prepare")
    shutil.rmtree(root, ignore_errors=True)
    ae_run = os.path.join(CLI_DIR, "runs", "ae")
    cfg = load_codec_config(ae_run)
    sr, n = cfg.sr, PREP_SAMPLES
    t0 = time.perf_counter()
    corpus, midi_corpus, n_chunks = _corpus(root, sr, n)
    log(f"dataset preparation: synthetic corpus of {n_chunks} kept chunks "
        f"of {n} samples ({n / sr:.3f} s) in "
        f"{time.perf_counter() - t0:.2f} s")

    # synthetic reference checkpoints: the port's random models at full
    # size under the reference's names.  The basic-pitch heads' biases are
    # set to -4, so that their activations are sparse as a trained model's
    # are (near 0.5 everywhere, the note search would follow every onset
    # to the end of the file)
    torch.manual_seed(SEED + 14)
    bp_model = BasicPitch(DEVICE)
    with torch.no_grad():
        for head in (bp_model.net.note_conv2, bp_model.net.onset_conv2):
            head.bias.fill_(-4.0)
    bp_path = os.path.join(root, "basic_pitch.pth")
    torch.save(reference_state_dict(bp_model), bp_path)
    bt_path = os.path.join(root, "beat_this.pth")
    torch.save(bt.reference_state_dict(bt.BeatThis()), bt_path)
    del bp_model

    # the encoder's ConvBlock1d shapes at batch PREP_BATCH, the kernel held
    # to its plain version at each, as phase 3 does
    codec = AudioCodec(cfg).eval().to(DEVICE)
    codec.load_state_dict(restore_checkpoint(ae_run)["codec_vars"])
    enc_path, _ = codec_conv_blocks(codec, n)
    per_batch = None
    if DEVICE == "cuda":
        with torch.no_grad():
            per_batch = check_fused_conv(enc_path, "encoded batch",
                                         PREP_BATCH)

    # one encoded batch under the profiler, before the commands (a profile
    # late in this process may lose a kernel record): the kernel's share
    # of its device time, the device's busy time and idle share
    batch = torch.as_tensor(np.stack([
        prep._chunk_signal(normalize_signal(load_wav(os.path.join(
            corpus, "three_chunks.wav"), sr=sr)[0]), n)[i % 3]
        for i in range(PREP_BATCH)])[..., None], device=DEVICE)
    with torch.inference_mode():
        codec.encode(batch)
        busy, k_ms, sum_ms = profile_kept(
            f"one encoded batch of {PREP_BATCH} x {n} samples",
            lambda: codec.encode(batch),
            (len(enc_path), per_batch["sum_launches"] if per_batch else 0))
    del batch
    if busy:
        log(f"dataset preparation: the kernel's share of an encoded batch's "
            f"device time {k_ms + sum_ms:.3f} of {busy:.3f} ms busy "
            f"({(k_ms + sum_ms) / busy:.3f}, the split sum's "
            f"{sum_ms:.3f} ms included); {card_line()}")

    # the command, its encodes, trackers and host transforms timed
    def prepare(out, timers):
        """One prepare_dataset run into ``out`` with ``timers`` in place;
        (wall s, s of it spent building the three models, device counts)."""
        builds = [_Timer(prep.CodecEncoderFn, "__init__", sync=True),
                  _Timer(BasicPitch, "__init__", sync=True),
                  _Timer(BasicPitch, "load_state_dict", sync=True),
                  _Timer(bt.Audio2Beats, "__init__", sync=True)]
        argv = ["prepare_dataset", "--input_path", corpus, "--output_path",
                out, "--emb_model_path", ae_run, "--num_signal", str(n),
                "--batch_size", str(PREP_BATCH), "--cut_silences",
                "--augmentations", "1", "--descriptors", "all",
                "--beat_track", "--beat_this_ckpt", bt_path, "--midi",
                "--basic_pitch", bp_path, "--save_waveform", "--device",
                DEVICE]
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        reset_device_launches(DEVICE)
        t0 = time.perf_counter()
        try:
            rc = cli_main(argv)
        finally:
            for t in builds + list(timers.values()):
                t.restore()
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"prepare_dataset: exit code {rc}")
        build = sum(sum(t.ms) for t in builds) / 1e3
        return wall, build, device_launches(DEVICE)

    store = os.path.join(root, "store")
    timers = {"encode": _Timer(prep.CodecEncoderFn, "__call__", sync=True),
              "beat_this": _Timer(bt.Audio2Beats, "__call__", sync=True),
              "basic_pitch": _Timer(BasicPitch, "transcribe", sync=True),
              "augment": _Timer(prep, "pitch_stretch_augment"),
              "descriptors": _Timer(prep, "audio_descriptors")}
    wall, build, (launches, _) = prepare(store, timers)
    encodes = len(timers["encode"].ms)
    want_encodes = 2 * math.ceil(n_chunks / PREP_BATCH)
    if encodes != want_encodes or launches != encodes * len(enc_path):
        fail(f"prepare_dataset: {encodes} encodes (expected {want_encodes}) "
             f"and {launches} {KERNEL_NAME} launches counted on the device, "
             f"expected {len(enc_path)} an encoded batch")
    # a second run in this process, the kernel, cuDNN and the allocator
    # warm: its records/s without the models' construction is the rate a
    # corpus far longer than this one sees
    warm_wall, warm_build, _ = prepare(os.path.join(root, "store_warm"), {})
    steady = n_chunks / (warm_wall - warm_build)
    log(f"dataset preparation: prepare_dataset on {DEVICE}: {n_chunks} "
        f"records in {wall:.2f} s ({n_chunks / wall:.3f} records/s, the "
        f"command's start-up, {build:.2f} s of model construction and the "
        f"first calls inside); a second run in this process {warm_wall:.2f} "
        f"s, {warm_build:.2f} s of it model construction, steady "
        f"{steady:.3f} records/s; "
        f"{encodes} encoded batches of {PREP_BATCH} x {n} samples, "
        f"{launches // encodes} {KERNEL_NAME} launches each counted on the "
        f"device (the encoder's {len(enc_path)} ConvBlock1d); ms an encoded "
        f"batch (synchronized) median {timers['encode'].median():.2f} "
        f"({spread([t / 1e3 for t in timers['encode'].ms])}); Beat This ms "
        f"a chunk median "
        f"{timers['beat_this'].median():.2f} over "
        f"{len(timers['beat_this'].ms)}; basic-pitch ms a file median "
        f"{timers['basic_pitch'].median():.2f} over "
        f"{len(timers['basic_pitch'].ms)}; host ms a record: augmentation "
        f"{timers['augment'].median():.2f}, descriptors "
        f"{timers['descriptors'].median():.2f}; {card_line()}")
    if per_batch is not None:
        log(f"dataset preparation: the kernel's share of an encoded batch's "
            f"synchronized wall time {per_batch['ms']:.3f} of "
            f"{timers['encode'].median():.2f} ms "
            f"({per_batch['ms'] / timers['encode'].median():.3f}; its ms "
            f"from CUDA events at these shapes, the batch's median)")

    # the records: keys, shapes, finite values, chunks and MIDI
    reader = RecordReader(store)
    z_len = n // cfg.ratio
    shapes = {"z": (cfg.z_channels, z_len), "z_aug_0": (cfg.z_channels,
                                                        z_len),
              "waveform": (n,), "beat_clock": (z_len,),
              "downbeat_clock": (z_len,), "midi_bytes": None,
              **{d: (z_len,) for d in prep.KNOWN_DESCRIPTORS}}
    chunks = []
    for key in reader.keys():
        ae = AudioExample(reader.get(key))
        if set(ae.get_keys()) != set(shapes):
            fail(f"prepare_dataset record {key}: keys {sorted(ae.get_keys())}")
        for name, shape in shapes.items():
            if shape is None:
                midi_io.loads(ae.get_bytes(name))
                continue
            v = ae.get(name)
            if v.shape != shape or not np.isfinite(v).all():
                fail(f"prepare_dataset record {key}: {name} of shape "
                     f"{v.shape} (expected {shape}) or not finite")
        meta = ae.get_metadata()
        chunks.append((meta["name"], int(meta["chunk"])))
    want = [("half_silent", 0), ("padded_tail", 0), ("padded_tail", 1),
            ("padded_tail", 2), ("padded_tail", 3), ("short", 0),
            ("three_chunks", 0), ("three_chunks", 1), ("three_chunks", 2)]
    if chunks != want:
        fail(f"prepare_dataset records {chunks}, expected {want}")

    # the latents of two records against the port's plain versions on the
    # CPU (the chunks rebuilt as the command builds them), and the TF32
    # reading beside the limit
    _, cpu_encode = make_codec_coder(ae_run, "cpu")
    errs, errs_tf32, scale = [], [], 0.0
    for name, chunk_i in (("padded_tail", 3), ("three_chunks", 0)):
        x, _ = load_wav(os.path.join(corpus, f"{name}.wav"), sr=sr)
        chunk = prep._chunk_signal(normalize_signal(x), n)[chunk_i]
        key = reader.keys()[want.index((name, chunk_i))]
        z_card = AudioExample(reader.get(key)).get("z")
        z_cpu = cpu_encode(chunk[None, :, None])[0].T.numpy()
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with torch.no_grad():
            z_tf32 = codec.encode(torch.as_tensor(chunk[None, :, None],
                                                  device=DEVICE))[0].T
        strict_f32()
        errs.append(float(np.abs(z_card - z_cpu).max()))
        errs_tf32.append(float(np.abs(z_tf32.detach().cpu().numpy()
                                      - z_cpu).max()))
        scale = max(scale, float(np.abs(z_cpu).max()))
    log(f"dataset preparation: z card vs CPU, 2 records: max abs err "
        f"{max(errs):.3e} (with TF32 allowed: {max(errs_tf32):.3e}), max|z| "
        f"{scale:.4f}, limit {CARD_VS_CPU_TOL} x max|z|")
    if not max(errs) <= CARD_VS_CPU_TOL * scale:
        fail("prepare_dataset: card and CPU latents disagree")

    # MIDI from a .mid file beside its audio (simple_midi)
    midi_store = os.path.join(root, "midi_store")
    if cli_main(["prepare_dataset", "--input_path", midi_corpus,
                 "--output_path", midi_store, "--parser", "simple_midi",
                 "--midi", "--emb_model_path", ae_run, "--num_signal", str(n),
                 "--batch_size", str(PREP_BATCH), "--device", DEVICE]) != 0:
        fail("prepare_dataset --parser simple_midi: non-zero exit")
    midi_reader = RecordReader(midi_store)
    notes = midi_io.loads(AudioExample(midi_reader.get(
        midi_reader.keys()[0])).get_bytes("midi_bytes")).notes
    source = midi_io.MidiFile(os.path.join(midi_corpus, "with_midi.mid"))
    if [(x.pitch, x.start) for x in notes] != [
            (x.pitch, x.start) for x in source.slice(0.0, n / sr).notes]:
        fail("prepare_dataset --midi: the record's notes are not the .mid's")

    # the store feeds train, then update_dataset re-encodes it
    runs = os.path.join(root, "runs")
    rc, out, steps, _ = cli_run(
        ["train", "--name", "from_store", "--db_path", store, "--out_path",
         runs, "--config", "base", "--batch_size", str(PREP_BATCH),
         "--max_steps", str(PREP_TRAIN_STEPS), "--device", DEVICE,
         "--override", f"train.n_signal={DIFF_FRAMES}",
         "--override", f"train.steps_save={PREP_TRAIN_STEPS}",
         "--override", f"train.steps_valid={10 * PREP_TRAIN_STEPS}"],
        DiffusionTrainer)
    if rc != 0 or len(steps) != PREP_TRAIN_STEPS:
        fail(f"train on the prepared store: exit code {rc}, {len(steps)} "
             f"steps")
    updated = os.path.join(root, "updated")
    reset_device_launches(DEVICE)
    if cli_main(["update_dataset", "--dataset_path", store, "--output_path",
                 updated, "--emb_model_path", ae_run, "--device",
                 DEVICE]) != 0:
        fail("update_dataset: non-zero exit")
    up_launches = device_launches(DEVICE)[0]
    _, encode = make_codec_coder(ae_run, DEVICE)
    up_err = 0.0
    up_reader = RecordReader(updated)
    for key in up_reader.keys():
        ae = AudioExample(up_reader.get(key))
        direct = encode(ae.get("waveform")[None, :, None])[0].T.cpu().numpy()
        up_err = max(up_err, float(np.abs(ae.get("z") - direct).max()
                                   / np.abs(direct).max()))
    if len(up_reader) != n_chunks or up_launches != n_chunks * len(enc_path):
        fail(f"update_dataset: {len(up_reader)} records, {up_launches} "
             f"{KERNEL_NAME} launches counted on the device")
    if not up_err <= GRAPH_TOL:
        fail(f"update_dataset: z {up_err} x max|z| off a direct encode")
    log(f"dataset preparation: train took {PREP_TRAIN_STEPS} steps on the "
        f"prepared store (wall ms a step {wall_ms(steps)[0]:.2f}); "
        f"update_dataset re-encoded {len(up_reader)} records, "
        f"{up_launches // n_chunks} {KERNEL_NAME} launches a record counted "
        f"on the device, each z within {up_err:.3e} x max|z| of a direct "
        f"encode (limit {GRAPH_TOL})")
    no_forbidden_modules("dataset preparation")
    row["launches_prepare_dataset"] = launches
    row["launches_per_encoded_batch"] = launches // encodes
    if per_batch is not None:
        row["ms_per_encoded_batch"] = per_batch["ms"]
        row["plain_ms_per_encoded_batch"] = per_batch["plain_ms"]
        row["bound_ms_per_encoded_batch"] = per_batch["bound_ms"]
        row["library_ms_per_encoded_batch"] = per_batch["library_ms"]
        row["max_abs_err"] = max(row["max_abs_err"], per_batch["max_abs_err"])
    row["prepare_records_per_s"] = n_chunks / wall
    row["prepare_records_per_s_steady"] = steady
    row["prepare_encode_ms_median"] = timers["encode"].median()
    row["prepare_z_card_vs_cpu"] = max(errs) / scale


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at |v| (8 bits of mantissa with the hidden one)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def check_fused_conv_bf16(path, unit):
    """The kernel's bf16 instantiation against its plain bf16 version at
    every distinct shape of ``path`` ((ConvBlock1d of a bf16 codec, T) in
    the order one ``unit`` runs them at batch 1): within BF16_ULPS bf16 ulps
    of max |y|; against a float64 version of the same bf16 inputs within
    BF16_F64_RATIO x bf16 F.conv1d's error (on the plain version's bf16
    activation); times from CUDA graphs of the kernel, the plain version and
    bf16 F.conv1d; the bound (bf16 tensor cores or bytes); then the bf16
    split sum alone at each split shape, as check_fused_conv does the f32
    one.  Returns its numbers summed over one unit."""
    import torch
    import torch.nn.functional as F
    from after_tpu_torch.ops.conv import get_padding
    from after_tpu_torch.ops.kernels.fused_conv import (bf16_tiles,
                                                        snake_conv,
                                                        snake_conv_reference,
                                                        sum_splits,
                                                        sum_splits_reference)
    from after_tpu_torch.ops.snake import snake_beta

    bf16 = torch.bfloat16
    path_counts = Counter(block_shape(b, T) for b, T in path)
    blocks_by_shape = {block_shape(b, T): b for b, T in path}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    total = Counter()
    splits = Counter()
    worst, worst_ulps, f64_worst = 0.0, 0.0, (0.0, 0.0)
    log(f"bf16 kernels: {KERNEL16_NAME} per shape (k d C O T mode: n/{unit}, "
        f"plan frames/channels a tile/channels a stage/ring slots/splits/"
        f"blocks, max_abs_err in ulps of max|y|; kernel/plain/"
        f"F.conv1d bf16/bound ms; TFLOP/s, share of bound; float64 errors "
        f"kernel/F.conv1d bf16)")
    for shape, block in sorted(blocks_by_shape.items(),
                               key=lambda kv: str(kv[0])):
        k, d, C, O, T, mode = shape
        n = path_counts[shape]
        x = torch.randn((1, T, C), generator=gen, device="cuda").to(bf16)
        alpha, beta = block.act.alpha.detach(), block.act.beta.detach()
        w_k, w_lo = block.conv.kernel_weights()
        w = block.conv.effective_weight()
        b = block.conv.bias.detach()
        if not all(t.dtype == bf16 for t in (alpha, beta, w_k, w, b)):
            fail(f"bf16 kernels {shape}: the block's weights are not bf16")
        y = snake_conv(x, alpha, beta, w_k, w_lo, b, d, mode)
        ref = snake_conv_reference(x, alpha, beta, w, b, d, mode)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ulps = err / bf16_ulp(scale)
        if not (y.dtype == bf16 and ulps <= BF16_ULPS):
            fail(f"{KERNEL16_NAME} {shape}: {err} off its plain version, "
                 f"{ulps:.2f} bf16 ulps of max |y| {scale} (limit "
                 f"{BF16_ULPS})")
        worst, worst_ulps = max(worst, err), max(worst_ulps, ulps)
        # float64 on the same bf16 inputs, over F64_FRAMES frames
        xs = x[:, :F64_FRAMES].contiguous()
        r64 = snake_conv_reference(xs.double(), alpha.double(),
                                   beta.double(), w.double(), b.double(), d,
                                   mode)
        left, right = get_padding(k, 1, d, mode)
        e_kernel = (snake_conv(xs, alpha, beta, w_k, w_lo, b, d, mode)
                    .double() - r64).abs().max().item()
        act_s = F.pad(snake_beta(xs.float(), alpha.float(), beta.float())
                      .to(bf16).transpose(1, 2), (left, right))
        e_lib = (F.conv1d(act_s, w, b, dilation=d).transpose(1, 2).double()
                 - r64).abs().max().item()
        if not e_kernel <= BF16_F64_RATIO * e_lib:
            fail(f"{KERNEL16_NAME} {shape}: error against float64 "
                 f"{e_kernel} > {BF16_F64_RATIO} x bf16 F.conv1d's {e_lib}")
        f64_worst = (max(f64_worst[0], e_kernel), max(f64_worst[1], e_lib))
        act = F.pad(snake_beta(x.float(), alpha.float(), beta.float())
                    .to(bf16).transpose(1, 2), (left, right))
        ms = cuda_ms(lambda: snake_conv(x, alpha, beta, w_k, w_lo, b, d,
                                        mode))
        plain_ms = cuda_ms(
            lambda: snake_conv_reference(x, alpha, beta, w, b, d, mode))
        lib_ms = cuda_ms(lambda: F.conv1d(act, w, b, dilation=d))
        flops = 2.0 * k * C * O * T
        nbytes = 2.0 * (T * C + 2 * C + O * C * k + O + T * O)
        bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
        total.update(ms=n * ms, plain_ms=n * plain_ms, library_ms=n * lib_ms,
                     bound_ms=n * bound_ms, flops=n * flops,
                     bytes=n * nbytes)
        plan = bf16_tiles(1, T, C, O, k, d)
        log(f"  {k} {d} {C} {O} {T} {mode}: {n}, {'/'.join(map(str, plan))}"
            f", {err:.3e} ({ulps:.2f}); {ms:.4f}/{plain_ms:.4f}/"
            f"{lib_ms:.4f}/{bound_ms:.4f}; {flops / ms / 1e9:.1f}, "
            f"{bound_ms / ms:.3f}; {e_kernel:.3e}/{e_lib:.3e}")
        if plan[4] > 1:
            splits[(plan[4], 1, T, O)] += n
    total["launches"] = len(path)
    log(f"bf16 kernels: {SUM16_NAME} at each split shape of the {unit} "
        f"(splits B T O: n/{unit}, inputs rotated, max_abs_err; kernel/plain/"
        f"torch.sum/bound(bytes) ms, share of bound)")
    sum_err = 0.0
    for (parts, B_, T_, O_), n in sorted(splits.items()):
        nbytes = (4.0 * parts + 2.0) * B_ * T_ * O_
        wss = [torch.randn((parts, B_, T_, O_), generator=gen, device="cuda")
               for _ in range(max(2, math.ceil(ROTATE_BYTES / nbytes)))]
        err = max((sum_splits(ws, bf16).float()
                   - sum_splits_reference(ws, bf16).float()).abs().max()
                  .item() for ws in wss[:2])
        if err != 0:
            fail(f"{SUM16_NAME} {tuple(wss[0].shape)}: {err} off its plain "
                 f"version")
        sum_err = max(sum_err, err)
        ms = rotating_ms(lambda ws: sum_splits(ws, bf16), wss)
        plain_ms = rotating_ms(lambda ws: sum_splits_reference(ws, bf16),
                               wss)
        lib_ms = rotating_ms(lambda ws: torch.sum(ws, dim=0).to(bf16), wss)
        del wss
        bound_ms = 1e3 * nbytes / PEAK_BYTES
        total.update(sum_ms=n * ms, sum_plain_ms=n * plain_ms,
                     sum_library_ms=n * lib_ms, sum_bound_ms=n * bound_ms,
                     sum_launches=n)
        log(f"  {parts} {B_} {T_} {O_}: {n}, {err:.1e}; {ms:.4f}/"
            f"{plain_ms:.4f}/{lib_ms:.4f}/{bound_ms:.4f}, "
            f"{bound_ms / ms:.3f}")
        if bound_ms > ms:
            fail(f"{SUM16_NAME} {(parts, B_, T_, O_)}: {ms:.4f} ms beats its "
                 f"byte bound {bound_ms:.4f} ms: the bound is wrong")
    total["sum_max_abs_err"] = sum_err
    total["bound_by"] = ("operations" if total["flops"] / PEAK_BF16_FLOPS
                         >= total["bytes"] / PEAK_BYTES else "bytes")
    total["share"] = total["bound_ms"] / total["ms"]
    total["tflops"] = total["flops"] / total["ms"] / 1e9
    total["max_abs_err"] = worst
    total["ulps"] = worst_ulps
    total["f64"] = f64_worst
    log(f"bf16 kernels: {KERNEL16_NAME} per {unit} ({len(path)} launches, "
        f"{total['flops'] / 1e9:.2f} GFLOP): kernel {total['ms']:.3f} ms "
        f"({total['tflops']:.1f} TFLOP/s, {total['share']:.3f} of the "
        f"bound), plain {total['plain_ms']:.3f} ms, F.conv1d bf16 "
        f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.4f} ms "
        f"(bf16 tensor cores at {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s or "
        f"{PEAK_BYTES / 1e12} TB/s: {total['bound_by']}); max abs err "
        f"{worst:.3e} ({worst_ulps:.2f} ulps of max |y|); against float64: "
        f"kernel {f64_worst[0]:.3e}, F.conv1d bf16 {f64_worst[1]:.3e}; "
        f"{SUM16_NAME} {total['sum_launches']} launches, "
        f"{total['sum_ms']:.4f} ms (plain {total['sum_plain_ms']:.4f}, "
        f"torch.sum {total['sum_library_ms']:.4f}, bound "
        f"{total['sum_bound_ms']:.4f})")
    return total


def bf16_rows(per_transfer, per_buffer, launches, sum_launches):
    """The kernel table's rows of the bf16 instantiation and of its split
    sum: launches of the bf16 main path's 3 replayed transfers (counted on
    the device), times per transfer and per buffer."""
    src = "after_tpu_torch/csrc/fused_snake_conv.cu"
    kernel = {"name": KERNEL16_NAME, "route": "cuda", "source": src,
              "replaces": "after_tpu/ops/pallas/fused_conv.py:129",
              "launches": launches,
              "max_abs_err": max(per_transfer["max_abs_err"],
                                 per_buffer["max_abs_err"]),
              "max_err_bf16_ulps": max(per_transfer["ulps"],
                                       per_buffer["ulps"]),
              "ms": per_transfer["ms"], "plain_ms": per_transfer["plain_ms"],
              "bound_ms": per_transfer["bound_ms"],
              "bound_by": per_transfer["bound_by"],
              "library_ms": per_transfer["library_ms"],
              "tflops": per_transfer["tflops"],
              "share_of_bound": per_transfer["share"],
              "ms_per_buffer": per_buffer["ms"],
              "plain_ms_per_buffer": per_buffer["plain_ms"],
              "bound_ms_per_buffer": per_buffer["bound_ms"],
              "library_ms_per_buffer": per_buffer["library_ms"],
              "f64_err": max(per_transfer["f64"][0], per_buffer["f64"][0]),
              "f64_err_conv1d_bf16": max(per_transfer["f64"][1],
                                         per_buffer["f64"][1])}
    sums = {"name": SUM16_NAME, "route": "cuda", "source": src,
            "replaces": "after_tpu/ops/pallas/fused_conv.py:129",
            "launches": sum_launches,
            "max_abs_err": max(per_transfer["sum_max_abs_err"],
                               per_buffer["sum_max_abs_err"]),
            "ms": per_transfer["sum_ms"],
            "plain_ms": per_transfer["sum_plain_ms"],
            "bound_ms": per_transfer["sum_bound_ms"], "bound_by": "bytes",
            "library_ms": per_transfer["sum_library_ms"],
            "ms_per_buffer": per_buffer["sum_ms"],
            "bound_ms_per_buffer": per_buffer["sum_bound_ms"]}
    return kernel, sums


def bf16_phase(cfg, pipe, requests, ref_outs, short, size32=None) -> list:
    """Phase 16: bf16 serving (see the module docstring).  ``pipe`` is the
    f32 pipeline of phase 4, ``requests`` and ``ref_outs`` its requests and
    the f32 outputs of its 3 replayed transfers (noise from generators
    seeded 0, 1, 2), ``short`` phase 5's clip, noise and CPU f32 output,
    ``size32`` the bytes of phase 13's f32 artifact where there is one.
    Returns the kernel table's two bf16 rows."""
    import os

    import numpy as np
    import torch
    from after_tpu_torch import TransferPipeline
    from after_tpu_torch.cli.export import load_run
    from after_tpu_torch.cli.main import main as cli_main
    from after_tpu_torch.models.autoencoder import ConvBlock1d
    from after_tpu_torch.ops.kernels.fused_conv import (device_launches,
                                                        fused_snake_conv,
                                                        reset_device_launches)
    from after_tpu_torch.streaming import Streamer
    from after_tpu_torch.streaming.export import ExportedStreamer
    from after_tpu_torch.streaming.state import flatten_state

    bf16 = torch.bfloat16
    gc.collect()
    torch.cuda.empty_cache()
    log(f"bf16: card {card_line()}")
    t0 = time.perf_counter()
    p16 = pipe.with_compute_dtype("bfloat16")
    torch.cuda.synchronize()
    log(f"bf16: the pipeline at compute_dtype bfloat16 from phase 4's "
        f"weights, cast once, in {time.perf_counter() - t0:.2f} s")

    # 1. the kernel's bf16 instantiation at every shape of a bf16 transfer
    # and of a bf16 buffer
    enc, dec = codec_conv_blocks(p16.codec, N_SAMPLES)
    path = enc + enc + dec
    window = (N_FADE + CHUNK) * cfg.autoencoder.ratio
    enc_w, dec_w = codec_conv_blocks(p16.codec, window)
    stream_path = enc_w + enc_w + dec_w
    pause_background()      # the timed section, the compiles stopped
    with torch.no_grad():
        per_transfer = check_fused_conv_bf16(path, "transfer")
        per_buffer = check_fused_conv_bf16(stream_path, "buffer")
    resume_background()

    # 2. the main path in bf16: 3 transfers replayed from the graph, the
    # device's counts (bf16 and f32) set to 0 just before and read after
    kw = dict(nb_steps=NB_STEPS, guidance_timbre=GUIDANCE_TIMBRE)
    seen = Counter()
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.update(
        [(block_shape(mod, args[0].shape[1]), args[0].dtype)]))
        for m in p16.codec.modules() if isinstance(m, ConvBlock1d)]
    pause_background()      # the timed section, the compiles stopped
    t0 = time.perf_counter()
    p16.transfer(*requests[0], **kw)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    for h in hooks:
        h.remove()
    if {dt for _, dt in seen} != {bf16} or sum(seen.values()) != 2 * len(
            path):
        fail(f"bf16 transfer: the warm-up and the capture ran "
             f"{sum(seen.values())} ConvBlock1d calls of types "
             f"{ {dt for _, dt in seen} }")
    fused_snake_conv.launches = 0
    reset_device_launches()
    times, outs = [], []
    for i, (a, b) in enumerate(requests[1:]):
        t0 = time.perf_counter()
        y = p16.transfer(a, b, **kw,
                         generator=torch.Generator("cuda").manual_seed(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(y)
    launches16, sums16 = device_launches(dtype=bf16)
    launches32 = device_launches()
    if launches16 != N_REQUESTS * len(path) or launches32 != (0, 0):
        fail(f"bf16 transfers: the device counted {launches16} "
             f"{KERNEL16_NAME} launches (expected {len(path)} a transfer) "
             f"and {launches32} f32 ones (expected none)")
    if fused_snake_conv.launches:
        fail("a replayed bf16 transfer called the kernel's wrapper")
    if sums16 != N_REQUESTS * per_transfer["sum_launches"]:
        fail(f"bf16 transfers: the device counted {sums16} {SUM16_NAME} "
             f"launches, the kernel phase expects "
             f"{per_transfer['sum_launches']} a transfer")
    coss = []
    for i, (y, ref) in enumerate(zip(outs, ref_outs)):
        if y.dtype != torch.float32 or tuple(y.shape) != tuple(ref.shape) \
                or not torch.isfinite(y).all():
            fail(f"bf16 request {i}: {y.dtype} {tuple(y.shape)} or "
                 f"non-finite")
        cos = torch.nn.functional.cosine_similarity(
            y.flatten().double(), ref.flatten().double(), dim=0).item()
        coss.append(cos)
        if not cos >= BF16_COS:
            fail(f"bf16 request {i}: cosine {cos} to phase 4's f32 output "
                 f"< {BF16_COS}")
    # the same requests op by op
    p16.eager = True
    p16.transfer(*requests[0], **kw)
    reset_device_launches()
    eager_times, eager_outs = [], []
    for i, (a, b) in enumerate(requests[1:]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_outs.append(p16.transfer(
            a, b, **kw, generator=torch.Generator("cuda").manual_seed(i)))
        torch.cuda.synchronize()
        eager_times.append(time.perf_counter() - t0)
    if device_launches(dtype=bf16) != (launches16, sums16):
        fail(f"bf16 transfers op by op: the device counted "
             f"{device_launches(dtype=bf16)}")
    p16.eager = False
    med, eager_med = (sorted(t)[len(t) // 2] for t in (times, eager_times))
    log(f"bf16 serving: first request {first_ms:.2f} ms (warm-up, capture, "
        f"replay); {N_REQUESTS} requests, median {med * 1e3:.2f} ms per "
        f"transfer as a CUDA graph, {eager_med * 1e3:.2f} ms op by op; "
        f"the device counted {launches16 // N_REQUESTS} {KERNEL16_NAME} and "
        f"{sums16 // N_REQUESTS} {SUM16_NAME} launches a replayed transfer "
        f"and no f32 one; output f32, cosine to phase 4's f32 outputs "
        + ", ".join(f"{c:.6f}" for c in coss) + f" (limit {BF16_COS})")
    agree(f"bf16 serving: graph vs eager, {N_REQUESTS} transfers", outs,
          eager_outs)

    a, b = requests[1]

    def phase_times():
        phases = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            phases[name] = (time.perf_counter() - t) * 1e3
            return out

        z_s = timed("encode_structure_audio", lambda: p16.encode(a))
        z_t = timed("encode_timbre_audio", lambda: p16.encode(b))
        tc = timed("structure", lambda: p16.structure(z_s))
        c = timed("timbre", lambda: p16.timbre(z_t))
        x0 = torch.randn(z_s.shape, generator=torch.Generator("cuda")
                         .manual_seed(0), device="cuda")
        z = timed("sample", lambda: p16.diffuse(x0, c, tc, NB_STEPS,
                                                GUIDANCE_TIMBRE))
        timed("decode", lambda: p16.decode(z))
        return phases

    for eager in (False, True):
        p16.eager = eager
        phase_times()
        phases = phase_times()
        log(f"bf16 serving: phases {'op by op' if eager else 'as CUDA graphs'}"
            f" (ms) " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
            + f", sum {sum(phases.values()):.2f}")
    p16.eager = False
    # the profiler may lose a kernel record late in this process, as in
    # phase 13: a profile is kept only where it recorded every launch
    profile_kept("one bf16 transfer as a CUDA graph",
                 lambda: p16.transfer(a, b, **kw),
                 (launches16 // N_REQUESTS, sums16 // N_REQUESTS), bf16=True)
    resume_background()

    # 3. card against CPU in bf16 on phase 5's clip, both held to the CPU's
    # f32 output by the bf16 rule of tests/test_torch_precision.py
    a_s, b_s, x0_s, y_cpu32 = short
    cpu16 = TransferPipeline(cfg, device="cpu", compute_dtype="bfloat16")
    cpu16.codec.load_state_dict(p16.codec.state_dict())
    cpu16.rf.load_state_dict(p16.rf.state_dict())
    skw = dict(nb_steps=SHORT_STEPS, guidance_timbre=GUIDANCE_TIMBRE,
               x0=x0_s)
    pause_background()      # the timed section, the compiles stopped
    t0 = time.perf_counter()
    y16_cpu = cpu16.transfer(a_s, b_s, **skw)
    cpu_s = time.perf_counter() - t0
    resume_background()
    y16_card = p16.transfer(a_s, b_s, **skw).cpu()
    scale = y_cpu32.abs().max().item()
    err = (y16_card - y16_cpu).abs().max().item()
    err_card = (y16_card - y_cpu32).abs().max().item()
    err_cpu = (y16_cpu - y_cpu32).abs().max().item()
    limit = 2 * err_cpu + 1e-6 * scale
    cos = torch.nn.functional.cosine_similarity(
        y16_card.flatten().double(), y16_cpu.flatten().double(), dim=0).item()
    scale16 = y16_cpu.abs().max().item()
    log(f"bf16 card vs CPU: {SHORT_SAMPLES} samples, {SHORT_STEPS} steps: "
        f"card bf16 vs CPU bf16 max abs err {err:.3e} ({err / scale16:.4f} x "
        f"max |y| {scale16:.4f}, limit {BF16_CARD_CPU_TOL}), cosine "
        f"{cos:.6f} (limit {BF16_CARD_CPU_COS}); card bf16 vs CPU f32 "
        f"{err_card:.3e}, max |y| {scale:.4f}, limit 2 x CPU bf16 vs CPU "
        f"f32 ({err_cpu:.3e}) + 1e-6 x max |y| = {limit:.3e}; the CPU's "
        f"bf16 transfer {cpu_s:.1f} s")
    if not (torch.isfinite(y16_card).all() and err_card <= limit
            and err <= BF16_CARD_CPU_TOL * scale16
            and cos >= BF16_CARD_CPU_COS):
        fail("bf16: card and CPU disagree")
    del cpu16

    # 4. the bf16 streamer: phase 4's first request as 64 buffers at
    # nb_steps 1 and 4, as graphs and op by op
    streamer = Streamer(cfg, chunk_size=CHUNK, n_fade=N_FADE, pipeline=p16)
    eager_streamer = Streamer(cfg, chunk_size=CHUNK, n_fade=N_FADE,
                              pipeline=p16, eager=True)
    A = streamer.audio_chunk
    pause_background()      # the timed section, the compiles stopped
    for st in (streamer, eager_streamer):                  # warm-up
        stream_audio(st, st.init_state(1), a[:, :STREAM_WARMUP * A],
                     b[:, :STREAM_WARMUP * A], STREAM_STEPS[-1])
    n_buffers = N_SAMPLES // A
    x0s = np.random.RandomState(SEED + 6).randn(
        n_buffers, 1, CHUNK, cfg.denoiser.n_channels).astype(np.float32)
    medians = {}
    for nb in STREAM_STEPS:
        state = streamer.init_state(1)
        floating = {t.dtype for t in flatten_state(state).values()
                    if t.is_floating_point()}
        if floating != {bf16}:
            fail(f"the bf16 stream state holds {floating}")
        captures = streamer.graphs.captures
        reset_device_launches()
        times, ys = stream_audio(streamer, state, a, b, nb, x0s=x0s)
        launches, sums = device_launches(dtype=bf16)
        if launches != len(stream_path) * n_buffers or device_launches() != (
                0, 0):
            fail(f"bf16 streaming: the device counted {launches} "
                 f"{KERNEL16_NAME} launches in {n_buffers} buffers, expected "
                 f"{len(stream_path)} a buffer, and {device_launches()} f32")
        if streamer.graphs.captures != captures:
            fail("a bf16 stream state was captured again")
        n_eager = EAGER_STREAM_BUFFERS
        eager_times, eager_ys = stream_audio(
            eager_streamer, eager_streamer.init_state(1), a[:, :n_eager * A],
            b[:, :n_eager * A], nb, x0s=x0s[:n_eager])
        medians[nb] = sorted(times)[n_buffers // 2] * 1e3
        log(f"bf16 streaming: nb_steps {nb}, {n_buffers} buffers, median / "
            f"p90 / max ms per buffer as CUDA graphs {spread(times)}, op by "
            f"op (the first {n_eager}) {spread(eager_times)}; "
            f"{KERNEL16_NAME} and {SUM16_NAME} "
            f"launches counted on the device {launches / n_buffers:g} and "
            f"{sums / n_buffers:g} a buffer, none f32; the state's floating "
            f"leaves bf16")
        if any(y.dtype != torch.float32 for y in ys):
            fail("a bf16 stream's output is not f32")
        agree(f"bf16 streaming nb_steps {nb}: graph vs eager, the first "
              f"{n_eager} buffers", ys[:n_eager], eager_ys)
    resume_background()
    del eager_streamer

    # 5. a bf16 artifact of phase 12's runs, exported by the command, loaded
    # and played beside the live bf16 streamer over the same weights
    runs = os.path.join(CLI_DIR, "runs")
    ae_run, diff_run = os.path.join(runs, "ae"), os.path.join(runs, "diff")
    art16 = os.path.join(CLI_DIR, "after.audio.diff.bf16")
    gc.collect()
    t0 = time.perf_counter()
    rc = cli_main(["export", "--model_path", diff_run, "--emb_model_path",
                   ae_run, "--chunk_size", str(CHUNK), "--nb_steps",
                   str(EXPORT_STEPS), "--guidance_timbre",
                   str(GUIDANCE_TIMBRE), "--compute_dtype", "bfloat16",
                   "--out", art16, "--device", DEVICE])
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"export --compute_dtype bfloat16 exited with {rc}")
    with open(os.path.join(art16, "manifest.json")) as f:
        manifest = json.load(f)
    if "bfloat16" not in manifest["state_dtypes"]:
        fail("the bf16 artifact's state_dtypes hold no bfloat16")
    size16 = sum(_dir_bytes(art16).values())
    t0 = time.perf_counter()
    host = ExportedStreamer(art16, DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg_run, pipe_run = load_run(diff_run, ae_run, device=DEVICE)
    live = Streamer(cfg_run, CHUNK, N_FADE,
                    pipeline=pipe_run.with_compute_dtype("bfloat16"))
    del pipe_run
    host_times, host_ys = [], []
    nb = STREAM_STEPS[-1]
    host.set_attribute("nb_steps", nb)
    host.set_attribute("guidance_timbre", GUIDANCE_TIMBRE)
    pause_background()      # the timed section, the compiles stopped
    host.call("forward", a[:, :A], b[:, :A])                 # warm-up
    host.reset()
    reset_device_launches()
    for i in range(n_buffers):
        s = slice(i * A, (i + 1) * A)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = host.call("forward", a[:, s], b[:, s], x0=x0s[i])
        torch.cuda.synchronize()
        host_times.append(time.perf_counter() - t0)
        host_ys.append(y)
    resume_background()
    launches, _ = device_launches(dtype=bf16)
    if launches != len(stream_path) * n_buffers or device_launches() != (0,
                                                                         0):
        fail(f"bf16 artifact: the device counted {launches} {KERNEL16_NAME} "
             f"launches in {n_buffers} buffers and {device_launches()} f32")
    _, live_ys = stream_audio(live, live.init_state(1), a, b, nb, x0s=x0s)
    log(f"bf16 artifact: {art16}, {size16 / 2**20:.1f} MiB (the f32 "
        f"artifact of phase 13: "
        + (f"{size32 / 2**20:.1f} MiB" if size32 else "not measured")
        + f"); export {export_s:.2f} s, load with the capture {load_s:.2f} s;"
        f" nb_steps {nb}, {n_buffers} buffers, median / p90 / max ms per "
        f"buffer {spread(host_times)}; {launches / n_buffers:g} "
        f"{KERNEL16_NAME} launches a buffer counted on the device")
    agree(f"bf16 artifact nb_steps {nb}: artifact vs live bf16 streamer, "
          f"{n_buffers} buffers", host_ys, live_ys)
    log(f"bf16 summary: transfer {med * 1e3:.2f} ms (graph), buffer "
        + ", ".join(f"nb_steps {k} {v:.2f} ms" for k, v in medians.items())
        + f", {KERNEL16_NAME} {per_transfer['ms']:.3f} ms a transfer, "
        f"artifact {size16 / 2**20:.1f} MiB, "
        f"{sorted(host_times)[n_buffers // 2] * 1e3:.2f} ms an artifact "
        f"buffer")
    del host, live, streamer, p16
    gc.collect()
    torch.cuda.empty_cache()
    return list(bf16_rows(per_transfer, per_buffer, launches16, sums16))


# ---------------------------------------------------------------------------
# phase 17: bf16 training
# ---------------------------------------------------------------------------

BF16_TRAIN_STEPS = 10         # phase 17's bf16 codec run of fit (phase 8's)
BF16_DFT_STEPS = 3            # then on with stft_bf16_dft
BF16_GRAD_F64_RATIO = 2.0     # a bf16 backward kernel's float64 error <= this
                              # x that of bf16 F.conv1d's autograd backward
# bf16 codec steps card vs CPU, 16384 samples: limits about 2x the first
# reading (H100 80GB HBM3, 700 W: losses 6.266e-03 x max(|loss|, 0.01);
# per model the worst gradient tensor x max(max|g|, 1e-3 x the model's
# largest) and the median over tensors: codec 1.560 and 0.756, the
# discriminator 0.816 and 0.0563).  The gradients part that far because a
# bf16 rounding placed otherwise moves them by up to 2x a tensor's max at
# these sizes (tests/test_torch_bf16_train_codec.py); the losses hold
BF16_TRAIN_CPU_TOL = {"loss": 0.0125, "codec": (3.2, 1.5),
                      "disc": (1.7, 0.12)}
BF16_CLI_DIR = "build/cli16"  # phase 17's stores and runs
DGRAD16_NAME = "snake_conv_dgrad_bf16"
WGRAD16_NAME = "snake_conv_wgrad_bf16"


def bf16_grad_f64(args, every):
    """Float64 gradients of the bf16 backward's function (the activation
    rounded to bf16 for the product, as the bf16 forward multiplies it)
    on ``args`` = (g, x, alpha, beta, w_k, b, d, mode), each bf16."""
    import torch
    from after_tpu_torch.ops.kernels.fused_conv import _conv, torch_weight
    from after_tpu_torch.ops.snake import snake_beta
    g, *ins, d, mode = args
    leaves = [t.double().requires_grad_() for t in ins]
    x, alpha, beta, w_k, b = leaves
    a = snake_beta(x, alpha, beta)
    a = a + (a.to(torch.bfloat16).double() - a).detach()
    y = _conv(a, torch_weight(w_k, x.shape[2]), b, d, mode)
    return torch.autograd.grad(y, leaves, g.double())


def check_gradients_bf16(path, batch: int):
    """Phase 17(b): the bf16 backward kernels at every distinct shape of
    ``path`` (the encoder of a bf16 training forward) at ``batch``: each of
    the five gradients within BF16_ULPS bf16 ulps of its plain version's
    max |g|; on F64_FRAMES frames the kernels' error against float64 (the
    worst tensor's, over its max |g|) within BF16_GRAD_F64_RATIO x that of
    bf16 F.conv1d's autograd backward of the bf16 snake + conv; the same
    bits from two launches and from a CUDA graph replay; times from CUDA
    graphs of dgrad and wgrad (each asked for its own gradients), their
    plain versions' and bf16 F.conv1d's autograd backward for the same
    gradients (cudnn.benchmark off and on), and the bound: the larger of
    the work at 989 TFLOP/s (bf16 tensor cores) and the bytes (each bf16
    input read once, each output written once) at 3.35 TB/s.  Returns
    these summed over one generator step's launches."""
    import torch
    import torch.nn.functional as F
    from after_tpu_torch.ops.conv import get_padding, weight_norm
    from after_tpu_torch.ops.kernels.fused_conv import (
        backward_plan, bf16_tiles, bf16_wgrad_tiles, kernel_weight,
        snake_conv_backward, snake_conv_backward_reference)
    from after_tpu_torch.ops.snake import snake_beta

    bf = torch.bfloat16
    counts = Counter(block_shape(b, T) for b, T in path)
    blocks = {block_shape(b, T): b for b, T in path}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    every = [True] * 5
    want = {"dgrad": [True, True, True, False, True],
            "wgrad": [False, False, False, True, False]}
    tot, worst = Counter(), Counter()
    log(f"bf16 gradients: the bf16 backward kernels at batch {batch} (k d C "
        "O T mode: n, plan; dgrad's frames/channels a tile/channels a stage/"
        "ring slots/rows of partials/blocks; wgrad's input channels a tile/"
        "taps a stage/output channels a block/1 or 2 (alternate chunks)/ring "
        "slots/splits/work items/blocks; worst |g - g_plain| in bf16 ulps"
        " of max|g_plain|"
        " dgrad/wgrad; float64 errors kernels/bf16 F.conv1d; ms from CUDA "
        "graphs: dgrad, wgrad, plain dgrad/wgrad, bf16 F.conv1d input/weight "
        "(cudnn.benchmark on), bound dgrad/wgrad)")
    for shape, block in sorted(blocks.items(), key=lambda kv: str(kv[0])):
        k, d, C, O, T, mode = shape
        n = counts[shape]
        with torch.no_grad():
            w = weight_norm(block.conv.weight, block.conv.g).to(bf)
        x = torch.randn((batch, T, C), generator=gen, device="cuda").to(bf)
        gy = torch.randn((batch, T, O), generator=gen, device="cuda").to(bf)
        alpha, beta = (p.detach().to(bf) for p in (block.act.alpha,
                                                   block.act.beta))
        b = block.conv.bias.detach().to(bf)
        w_k = kernel_weight(w)[0]
        op_args = (gy, x, alpha, beta, w_k, b, d, mode)
        got = snake_conv_backward(*op_args, every)
        ref = snake_conv_backward_reference(*op_args, every)
        ulps = {}
        for i, (name, a, r) in enumerate(zip("x alpha beta w b".split(),
                                             got, ref)):
            scale = r.float().abs().max().item()
            err = (a.float() - r.float()).abs().max().item()
            u = err / bf16_ulp(scale) if scale else 0.0
            if not u <= BF16_ULPS:
                fail(f"bf16 snake_conv_backward {shape}: g{name} off its "
                     f"plain version by {u:.2f} bf16 ulps of max |g| > "
                     f"{BF16_ULPS}")
            kind = "wgrad" if i == 3 else "dgrad"
            ulps[kind] = max(ulps.get(kind, 0.0), u)
            worst[kind] = max(worst[kind], u)
            worst[kind + "_abs"] = max(worst[kind + "_abs"], err)
        if got[3][:, :, C:].any():
            fail(f"bf16 snake_conv_backward {shape}: gw's padded columns are "
                 "not zero")
        again = snake_conv_backward(*op_args, every)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            captured = snake_conv_backward(*op_args, every)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"bf16 snake_conv_backward {shape}: two launches differ")
        if not all(torch.equal(a, c) for a, c in zip(got, captured)):
            fail(f"bf16 snake_conv_backward {shape}: a CUDA graph replay "
                 "differs from the eager launch")
        del graph, captured, again, got, ref
        # against float64 on the first F64_FRAMES frames
        f = max(1, F64_FRAMES // batch)
        cut = (gy[:, :f].contiguous(), x[:, :f].contiguous(), alpha, beta,
               w_k, b, d, mode)
        r64 = bf16_grad_f64(cut, every)

        def err64(ts):
            return max(((t.double() - r).abs().max() / r.abs().max()).item()
                       for t, r in zip(ts, r64) if r.abs().max() > 0)
        left, right = get_padding(k, 1, d, mode)

        def conv16(xx, al, be, ww, bb):
            a = snake_beta(xx, al, be)
            return F.conv1d(F.pad(a.transpose(1, 2), (left, right)), ww, bb,
                            dilation=d).transpose(1, 2)
        lib_in = [t.detach().clone().requires_grad_() for t in
                  (cut[1], alpha, beta, w, b)]
        lib = torch.autograd.grad(conv16(*lib_in), lib_in, cut[0])
        lib = (lib[0], lib[1], lib[2], kernel_weight(lib[3])[0], lib[4])
        e64 = (err64(snake_conv_backward(*cut, every)), err64(lib))
        if not e64[0] <= BF16_GRAD_F64_RATIO * e64[1]:
            fail(f"bf16 snake_conv_backward {shape}: error against float64 "
                 f"{e64[0]:.3e} > {BF16_GRAD_F64_RATIO} x bf16 F.conv1d "
                 f"autograd's {e64[1]:.3e}")
        worst["f64"] = max(worst["f64"], e64[0])
        worst["f64_conv1d"] = max(worst["f64_conv1d"], e64[1])

        # times
        t = {kind: cuda_ms(lambda: snake_conv_backward(*op_args, m), reps=5,
                           warmup=1) for kind, m in want.items()}
        t_plain = {kind: cuda_ms(
            lambda: snake_conv_backward_reference(*op_args, m), reps=5,
            warmup=1) for kind, m in want.items()}
        a_pad = F.pad(snake_beta(x, alpha, beta).transpose(1, 2),
                      (left, right))
        gyt = gy.transpose(1, 2).contiguous()

        def conv(a, wl, bl):
            return F.conv1d(a, wl, bl, dilation=d)
        lib_ms = {}
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            lib_ms["dgrad", bench] = vjp_ms(conv, [a_pad, w, b], gyt,
                                            wrt=[True, False, False])
            lib_ms["wgrad", bench] = vjp_ms(conv, [a_pad, w, b], gyt,
                                            wrt=[False, True, True])
        torch.backends.cudnn.benchmark = False
        flops = 2.0 * k * C * O * T * batch
        nbytes = {"dgrad": 2.0 * (2 * batch * T * C + batch * T * O
                                  + k * O * C + 4 * C + O),
                  "wgrad": 2.0 * (batch * T * C + batch * T * O + 2 * C
                                  + k * O * w_k.shape[2])}
        bound = {kind: 1e3 * max(flops / PEAK_BF16_FLOPS,
                                 nbytes[kind] / PEAK_BYTES) for kind in want}
        for kind in want:
            tot[f"{kind}_ms"] += n * t[kind]
            tot[f"{kind}_plain_ms"] += n * t_plain[kind]
            tot[f"{kind}_library_ms"] += n * lib_ms[kind, False]
            tot[f"{kind}_library_benchmark_ms"] += n * lib_ms[kind, True]
            tot[f"{kind}_bound_ms"] += n * bound[kind]
            tot[f"{kind}_flops"] += n * flops
            tot[f"{kind}_bytes"] += n * nbytes[kind]
        tot["launches"] += n
        plan = backward_plan(batch, T, C, O, k, d, bf)
        tiles = bf16_tiles(batch, T, C, O, k, d, backward=True)
        wtiles = bf16_wgrad_tiles(batch, T, C, O, k, d)
        log(f"  {k} {d} {C} {O} {T} {mode}: {n}, {'/'.join(map(str, plan))}"
            f"; {'/'.join(map(str, tiles))}; {'/'.join(map(str, wtiles))};"
            f" {ulps['dgrad']:.2f}/{ulps['wgrad']:.2f}; {e64[0]:.2e}/"
            f"{e64[1]:.2e}; {t['dgrad']:.4f}, {t['wgrad']:.4f}, "
            f"{t_plain['dgrad']:.4f}/{t_plain['wgrad']:.4f}, "
            f"{lib_ms['dgrad', False]:.4f}/{lib_ms['wgrad', False]:.4f} "
            f"({lib_ms['dgrad', True]:.4f}/{lib_ms['wgrad', True]:.4f}), "
            f"{bound['dgrad']:.4f}/{bound['wgrad']:.4f}")
    for kind in want:
        ops = tot[f"{kind}_flops"] / PEAK_BF16_FLOPS
        tot[f"{kind}_bound_by"] = ("operations" if ops >= tot[f"{kind}_bytes"]
                                   / PEAK_BYTES else "bytes")
    tot.update({f"worst_{k}": v for k, v in worst.items()})
    log(f"bf16 gradients: per generator step ({tot['launches']} launches of "
        f"each bf16 kernel): dgrad {tot['dgrad_ms']:.3f} ms (plain "
        f"{tot['dgrad_plain_ms']:.3f}, bf16 F.conv1d autograd input "
        f"{tot['dgrad_library_ms']:.3f} / with cudnn.benchmark "
        f"{tot['dgrad_library_benchmark_ms']:.3f}, bound "
        f"{tot['dgrad_bound_ms']:.3f} by {tot['dgrad_bound_by']}; "
        f"{2 * tot['dgrad_flops'] / 1e9:.1f} GFLOP), wgrad "
        f"{tot['wgrad_ms']:.3f} ms (plain {tot['wgrad_plain_ms']:.3f}, bf16 "
        f"F.conv1d autograd weight and bias {tot['wgrad_library_ms']:.3f} / "
        f"{tot['wgrad_library_benchmark_ms']:.3f}, bound "
        f"{tot['wgrad_bound_ms']:.3f} by {tot['wgrad_bound_by']}); worst "
        f"{worst['dgrad']:.2f} / {worst['wgrad']:.2f} bf16 ulps (limit "
        f"{BF16_ULPS}); against float64 kernels {worst['f64']:.3e}, bf16 "
        f"F.conv1d {worst['f64_conv1d']:.3e}")
    return tot


def bf16_backward_row(kind: str, bwd, launches: int):
    """A bf16 backward kernel's row of the kernel table: launches in phase
    17's bf16 codec run (counted on the device), times per generator step
    from CUDA graphs (the encoder's launches), its plain version's and bf16
    F.conv1d's autograd backward for the same gradients."""
    return {"name": DGRAD16_NAME if kind == "dgrad" else WGRAD16_NAME,
            "route": "cuda",
            "source": "after_tpu_torch/csrc/snake_conv_backward.cu",
            "replaces": "after_tpu/ops/pallas/fused_conv.py:84",
            "launches": launches,
            "max_abs_err": bwd[f"worst_{kind}_abs"],
            "max_err_ulps": bwd[f"worst_{kind}"],
            "ms": bwd[f"{kind}_ms"], "plain_ms": bwd[f"{kind}_plain_ms"],
            "bound_ms": bwd[f"{kind}_bound_ms"],
            "bound_by": bwd[f"{kind}_bound_by"],
            "library_ms": bwd[f"{kind}_library_ms"],
            "library_benchmark_ms": bwd[f"{kind}_library_benchmark_ms"],
            "unit": "bf16 generator step (the encoder's convs)",
            "f64_err": bwd["worst_f64"],
            "f64_err_conv1d": bwd["worst_f64_conv1d"]}


def bf16_codec_training():
    """Phase 17(a): the base codec trained at compute_dtype bfloat16; see
    bf16_train_phase.  Returns the per-step device launch counts summed,
    the encoder's path and the per-kind medians."""
    import dataclasses

    import torch
    from after_tpu_torch.autoencoder import AutoencoderTrainer
    from after_tpu_torch.config import (AETrainConfig, DiscriminatorConfig,
                                        get_ae_config)
    from after_tpu_torch.ops.kernels.fused_conv import (
        backward_device_launches, device_launches, reset_device_launches)

    bf = torch.bfloat16
    ae = get_ae_config()
    tc = AETrainConfig(warmup_steps=TRAIN_WARMUP, compute_dtype="bfloat16")
    trainer = AutoencoderTrainer(ae, tc, DiscriminatorConfig(),
                                 device="cuda", seed=SEED).init(SEED)
    kinds = [trainer.step_kind(i)
             for i in range(BF16_TRAIN_STEPS + BF16_DFT_STEPS)]
    if kinds[:BF16_TRAIN_STEPS] != TRAIN_KINDS:
        fail(f"fit's schedule {kinds} differs from {TRAIN_KINDS}")
    enc, dec = codec_conv_blocks(trainer.codec, tc.num_signal)
    gen = torch.Generator("cuda").manual_seed(SEED)
    batches = [synthetic_audio(gen, tc.batch_size, tc.num_signal, ae.sr)
               for _ in range(BF16_TRAIN_STEPS + BF16_DFT_STEPS + 1)]
    records = []
    snap = {"codec": flat_params(trainer.codec),
            "disc": flat_params(trainer.disc)}

    def callback(tr, metrics):
        torch.cuda.synchronize()
        dt = time.perf_counter() - snap["t0"]
        kind = kinds[tr.step - 1]
        counts = {"fwd32": device_launches()[0],
                  "fwd16": device_launches(dtype=bf)[0],
                  "bwd32": backward_device_launches()[:2],
                  "bwd16": backward_device_launches(dtype=bf)[:2]}
        reset_device_launches()
        values = {k: float(v) for k, v in metrics.items()}
        codec, disc = flat_params(tr.codec), flat_params(tr.disc)
        moved = (not torch.equal(codec, snap["codec"]),
                 not torch.equal(disc, snap["disc"]))
        records.append((kind, dt, counts, values, moved))
        log(f"bf16 training: step {tr.step - 1} ({kind}"
            f"{', bf16 DFT' if tr.tc.stft_bf16_dft else ''}): "
            f"{dt * 1e3:.2f} ms, device launches {counts}, " +
            ", ".join(f"{k} {v:.5g}" for k, v in values.items()))
        snap.update(codec=codec, disc=disc)
        torch.cuda.synchronize()
        snap["t0"] = time.perf_counter()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_device_launches()
    torch.cuda.synchronize()
    snap["t0"] = time.perf_counter()
    trainer.fit(iter(batches[:BF16_TRAIN_STEPS]), max_steps=BF16_TRAIN_STEPS,
                callback=callback)
    peak = torch.cuda.max_memory_allocated()
    # then on with the MR-STFT's DFTs in bf16
    trainer.tc = dataclasses.replace(tc, stft_bf16_dft=True)
    trainer.fit(iter(batches[BF16_TRAIN_STEPS:-1]),
                max_steps=BF16_TRAIN_STEPS + BF16_DFT_STEPS,
                callback=callback)
    if len(records) != BF16_TRAIN_STEPS + BF16_DFT_STEPS:
        fail(f"bf16 fit ran {len(records)} steps")
    for i, (kind, _, c, values, moved) in enumerate(records):
        # the encoder runs at bf16; the bottleneck's f32 noise makes the
        # decoder run in f32 (as in the JAX trainer)
        gen_step = kind != "disc"
        want = {"fwd16": len(enc), "fwd32": len(dec),
                "bwd16": (len(enc),) * 2 if gen_step else (0, 0),
                "bwd32": (len(dec),) * 2 if gen_step else (0, 0)}
        if {k: tuple(v) if isinstance(v, (list, tuple)) else v
                for k, v in c.items()} != want:
            fail(f"bf16 training step {i} ({kind}): device launches {c}, "
                 f"expected {want}")
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"bf16 training step {i}: non-finite metrics {values}")
        if values.get("skipped_nonfinite", 0) != 0:
            fail(f"bf16 training step {i}: a generator update was skipped")
        if moved != ((True, False) if gen_step else (False, True)):
            fail(f"bf16 training step {i} ({kind}): codec, discriminator "
                 f"moved {moved}")
    if trainer.disc_optimizer.total_notfinite:
        fail("bf16 training: a discriminator update was skipped")
    for name, model in (("codec", trainer.codec), ("disc", trainer.disc)):
        if any(p.dtype != torch.float32 for p in model.parameters()):
            fail(f"bf16 training: the {name}'s parameters are not all f32")
    for opt in (trainer.optimizer, trainer.disc_optimizer):
        if opt._mu.dtype != torch.float32 or opt._nu.dtype != torch.float32:
            fail("bf16 training: an optimizer state is not f32")
    medians = {}
    for kind in ("warmup", "gan", "disc"):
        times = [dt for k, dt, *_ in records[:BF16_TRAIN_STEPS]
                 if k == kind][1:]
        medians[kind] = sorted(times)[len(times) // 2] * 1e3
    dft = [dt * 1e3 for _, dt, *_ in records[BF16_TRAIN_STEPS:]]
    log(f"bf16 training: {BF16_TRAIN_STEPS} steps at bf16, then "
        f"{BF16_DFT_STEPS} with the bf16 DFT; per step on the device "
        f"{len(enc)} bf16 and {len(dec)} f32 forward launches, and in each "
        f"generator step {len(enc)} bf16 and {len(dec)} f32 dgrad and wgrad "
        f"launches; masters and optimizer states f32; median host ms "
        f"without each kind's first step: warm-up generator "
        f"{medians['warmup']:.2f}, GAN generator {medians['gan']:.2f}, "
        f"discriminator {medians['disc']:.2f}; with the bf16 DFT "
        f"{', '.join(f'{v:.2f}' for v in dft)}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    w_wave, w_reg = trainer._recon_weights(trainer.step)
    trainer.tc = tc
    _, busy, counts, _ = profile_call(
        "one bf16 GAN generator step", lambda: trainer.gen_step(
            batches[-1], True, w_wave, w_reg))
    launches16 = [sum(c["bwd16"][j] for _, _, c, *_ in records)
                  for j in range(2)]
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return enc, launches16, medians, peak


def bf16_train_card_vs_cpu():
    """Phase 17(c): one bf16 GAN generator step and one bf16 discriminator
    step on the card and on the CPU, same weights, batch and noise."""
    import numpy as np
    import torch
    from after_tpu_torch.autoencoder import AutoencoderTrainer
    from after_tpu_torch.config import (AETrainConfig, DiscriminatorConfig,
                                        get_ae_config)

    ae = get_ae_config()
    tc = AETrainConfig(warmup_steps=TRAIN_WARMUP, batch_size=1,
                       num_signal=TRAIN_VS_CPU_SAMPLES,
                       compute_dtype="bfloat16")
    card = AutoencoderTrainer(ae, tc, DiscriminatorConfig(), device="cuda"
                              ).init(SEED)
    cpu = AutoencoderTrainer(ae, tc, DiscriminatorConfig(), device="cpu")
    cpu.codec.load_state_dict(card.codec.state_dict())
    cpu.disc.load_state_dict(card.disc.state_dict())
    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    x = synthetic_audio(gen, 1, TRAIN_VS_CPU_SAMPLES, ae.sr).cpu().numpy()
    noise = np.random.RandomState(SEED + 4).randn(
        1, TRAIN_VS_CPU_SAMPLES // ae.ratio, ae.z_channels).astype(np.float32)
    w_wave, w_reg = card._recon_weights(TRAIN_WARMUP + 1)

    def run(tr):
        gm, gg = tr.gen_grads(x, True, w_wave, w_reg, noise)
        dm, dg = tr.disc_grads(x, noise)
        return ({**{k: float(v) for k, v in gm.items()},
                 **{"disc_" + k: float(v) for k, v in dm.items()}},
                [g.cpu() for g in gg], [g.cpu() for g in dg])

    a, b = run(card), run(cpu)
    loss = max(abs(a[0][k] - v) / max(abs(v), 1e-2) for k, v in b[0].items())
    grads = {}
    for model, module, ga, gb in (("codec", card.codec, a[1], b[1]),
                                  ("disc", card.disc, a[2], b[2])):
        floor = 1e-3 * max(g.abs().max().item() for g in gb)
        ratios = sorted(
            ((p - q).abs().max().item() / max(q.abs().max().item(), floor),
             n) for (n, _), p, q in zip(module.named_parameters(), ga, gb))
        grads[model] = (*ratios[-1], ratios[len(ratios) // 2][0])
    tol = BF16_TRAIN_CPU_TOL
    log(f"bf16 training card vs CPU: {TRAIN_VS_CPU_SAMPLES} samples, a bf16 "
        f"GAN generator and discriminator step, fixed noise: losses within "
        f"{loss:.3e} x max(|loss|, 0.01) (limit {tol['loss']}); " +
        ", ".join(f"{k} {v:.5g}" for k, v in b[0].items()))
    ok = loss <= tol["loss"]
    for model in ("codec", "disc"):
        worst, name, median = grads[model]
        log(f"bf16 training card vs CPU, {model} gradients (x max(max|g|, "
            f"1e-3 x the model's largest)): worst {worst:.3e} ({name}; limit "
            f"{tol[model][0]}), median {median:.3e} (limit {tol[model][1]})")
        ok = ok and worst <= tol[model][0] and median <= tol[model][1]
    if not ok:
        fail("bf16 training: card and CPU disagree")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return loss, grads


def bf16_diffusion_training():
    """Phase 17(d): phase 10's config and batch at train.compute_dtype
    bfloat16, DIFF_STEPS steps of fit as CUDA graphs and op by op under
    cuDNN's deterministic algorithms; see bf16_train_phase."""
    import torch
    from after_tpu_torch.dataset import DeviceLatentBank
    from after_tpu_torch.diffusion.trainer import DiffusionTrainer

    cfg = diffusion_config(**{"train.compute_dtype": "bfloat16"})
    items = [{"z": z} for z in synthetic_latents(
        DIFF_RECORDS, cfg.denoiser.n_channels, DIFF_RECORD_FRAMES, SEED)]
    bank = DeviceLatentBank(items, DIFF_FRAMES, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def run(eager):
        tr = DiffusionTrainer(cfg, device="cuda", seed=SEED,
                              eager=eager).init(SEED)
        records = []
        snap = {}

        def callback(t, metrics):
            torch.cuda.synchronize()
            step = t.step - 1
            kind = t.step_kind(step)
            records.append((kind, time.perf_counter() - snap["t0"],
                            {k: v.clone() for k, v in metrics.items()},
                            (kind,) if kind == "classifier"
                            else (kind, *t.step_flags(step))))
            snap["t0"] = time.perf_counter()
        torch.cuda.synchronize()
        snap["t0"] = time.perf_counter()
        tr.fit(bank.batches(DIFF_BATCH, seed=SEED), max_steps=DIFF_STEPS,
               callback=callback)
        return tr, records

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graphed, records = run(False)
    peak = torch.cuda.max_memory_allocated()
    eager, eager_records = run(True)
    torch.backends.cudnn.deterministic = deterministic
    kinds = [k for k, *_ in records]
    if kinds != DIFF_KINDS:
        fail(f"bf16 diffusion: the steps ran {kinds}, expected {DIFF_KINDS}")
    if not 0 < graphed.graphs.captures <= DIFF_MAX_GRAPHS:
        fail(f"bf16 diffusion: {graphed.graphs.captures} captures")
    for (k, _, m, _), (_, _, e, _) in zip(records, eager_records):
        if not all(torch.isfinite(v).all() for v in m.values()):
            fail(f"bf16 diffusion: non-finite metrics in a {k} step")
        if int(m.get("skipped_nonfinite", 0)) != 0:
            fail(f"bf16 diffusion: a {k} update was skipped")
        if not all(torch.equal(m[n], e[n]) for n in m):
            fail(f"bf16 diffusion: a {k} step's metrics as a CUDA graph "
                 "and op by op differ under deterministic cuDNN")
    if not all(torch.equal(a, b) for a, b in zip(
            graphed.rf.state_dict().values(), eager.rf.state_dict().values())):
        fail("bf16 diffusion: parameters or statistics as CUDA graphs and "
             "op by op differ under deterministic cuDNN")
    if any(p.dtype != torch.float32 for p in graphed.rf.parameters()) or any(
            e.dtype != torch.float32 for e in graphed.ema) or any(
            b.dtype != torch.float32 for b in graphed.rf.buffers()
            if b.is_floating_point()):
        fail("bf16 diffusion: a master, the EMA or a statistic is not f32")
    for opt in (graphed.optimizer, graphed.cls_optimizer):
        if opt._mu.dtype != torch.float32:
            fail("bf16 diffusion: an optimizer state is not f32")
    medians = {}
    for label, recs in (("graph", records), ("eager", eager_records)):
        seen, times = set(), {}
        for k, dt, _, sig in recs:
            if sig in seen:        # not the first step of its signature
                times.setdefault(k, []).append(dt * 1e3)
            seen.add(sig)
        for kind in ("phase1", "diffusion", "cycle", "classifier"):
            t = sorted(times.get(kind, []))
            medians[kind, label] = t[len(t) // 2] if t else None
    # a kind whose every step above was its signature's first (the cycle
    # steps): three more steps of its last signature, replayed and op by op
    extra = next(iter(bank.batches(DIFF_BATCH, seed=SEED + 2)))
    captures = graphed.graphs.captures
    for kind in ("phase1", "diffusion", "cycle", "classifier"):
        if medians[kind, "graph"] is not None:
            continue
        last = max(i for i, k in enumerate(DIFF_KINDS) if k == kind)
        for label, t in (("graph", graphed), ("eager", eager)):
            def one(t=t):
                if kind == "classifier":
                    return t._classifier(extra)
                return t._diffusion(extra, t.step_flags(last),
                                    t.schedule_weights(last))
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            medians[kind, label] = sorted(times)[1]
    if graphed.graphs.captures != captures:
        fail("bf16 diffusion: a step of a captured signature was captured "
             "again")
    log(f"bf16 diffusion: {DIFF_STEPS} steps of every kind at batch "
        f"{DIFF_BATCH} as CUDA graphs ({graphed.graphs.captures} captures) "
        f"and op by op, the same bits under deterministic cuDNN; masters, "
        f"EMA, statistics and optimizer states f32; median host ms without "
        f"each signature's first step (graph / op by op; a kind without "
        f"such a step, of 3 more of its last signature): " + ", ".join(
            f"{k} {fmt_ms(medians[k, 'graph'])} / "
            f"{fmt_ms(medians[k, 'eager'])}" for k in (
                "phase1", "diffusion", "cycle", "classifier"))
        + f"; peak device memory {peak / 2**30:.2f} GiB")
    step = DIFF_KINDS.index("diffusion")
    batch = next(iter(bank.batches(DIFF_BATCH, seed=SEED + 1)))
    flags, weights = graphed.step_flags(step), graphed.schedule_weights(step)
    graphed._diffusion(batch, flags, weights)
    captures = graphed.graphs.captures
    profile_call("one replayed bf16 phase-2 diffusion step",
                 lambda: graphed._diffusion(batch, flags, weights))
    if graphed.graphs.captures != captures:
        fail("bf16 diffusion: the profiled step was captured again")
    del graphed, eager, bank
    gc.collect()
    torch.cuda.empty_cache()
    return medians, peak


def bf16_cli():
    """Phase 17(e): train_autoencoder and train at bf16 from the command
    line at full width, 2 steps each and a restart for one more (the
    diffusion run's validates through the codec run), every kernel launch
    of the restarts held to its plain version."""
    import os
    import shutil

    import numpy as np
    import torch
    from after_tpu_torch.autoencoder import AutoencoderTrainer
    from after_tpu_torch.dataset import AudioExample, RecordWriter
    from after_tpu_torch.diffusion.trainer import DiffusionTrainer
    from after_tpu_torch.ops.kernels.fused_conv import (
        device_launches, fused_snake_conv, reset_device_launches)
    from after_tpu_torch.utils.checkpoint import restore_checkpoint
    from torch.nn.modules.module import register_module_forward_hook

    sys.modules["torch.utils.tensorboard"] = None
    shutil.rmtree(BF16_CLI_DIR, ignore_errors=True)
    wave_db = os.path.join(BF16_CLI_DIR, "wavedb")
    z_db = os.path.join(BF16_CLI_DIR, "zdb")
    runs = os.path.join(BF16_CLI_DIR, "runs")
    gen = torch.Generator("cuda").manual_seed(SEED + 17)
    waves = synthetic_audio(gen, 8, CLI_RECORD_SAMPLES, 44100)[..., 0]
    with RecordWriter(wave_db) as w:
        for i, x in enumerate(waves.cpu().numpy()):
            e = AudioExample()
            e.put_array("waveform", x, dtype=np.int16, sampling_rate=44100)
            w.put(f"{i:08d}", e.serialize())
    with RecordWriter(z_db) as w:
        for i, z in enumerate(synthetic_latents(8, 64, 512, SEED + 17)):
            e = AudioExample()
            e.put_array("z", z)
            w.put(f"{i:08d}", e.serialize())
    out = {}
    for label, name, trainer_cls, args in (
            ("train_autoencoder", "ae", AutoencoderTrainer, [
                "train_autoencoder", "--name", "ae", "--db_path", wave_db,
                "--out_path", runs, "--batch_size", "8", "--num_signal",
                "131072", "--override", "train.warmup_steps=1",
                "--override", "train.steps_save=2",
                "--override", "train.steps_valid=100",
                "--override", "train.compute_dtype=bfloat16"]),
            ("train", "diff", DiffusionTrainer, [
                "train", "--name", "diff", "--db_path", z_db, "--out_path",
                runs, "--config", "base", "--config", "cycle",
                "--batch_size", str(DIFF_BATCH), "--compute_dtype",
                "bfloat16", "--emb_model_path", os.path.join(runs, "ae"),
                "--override", f"train.n_signal={DIFF_FRAMES}",
                "--override", "train.steps_save=2",
                "--override", "train.steps_valid=3"])):
        gc.collect()
        torch.cuda.empty_cache()
        rc, text, steps, _ = cli_run(args + ["--max_steps", "2"],
                                     trainer_cls)
        run = os.path.join(runs, name)
        if rc != 0 or len(steps) != 2:
            fail(f"{label} at bf16: exit code {rc}, {len(steps)} steps")
        saved = restore_checkpoint(run, 2)
        worst, checked = [0.0], [0]
        hook = register_module_forward_hook(
            snake_conv_check(f"{label} --restart at bf16", worst, checked))
        fused_snake_conv.launches = 0
        reset_device_launches()
        try:
            rc, text, steps, loaded = cli_run(
                args + ["--max_steps", "3", "--restart", "0"], trainer_cls)
        finally:
            hook.remove()
        launches = (fused_snake_conv.launches,
                    device_launches()[0] + device_launches(
                        dtype=torch.bfloat16)[0])
        if rc != 0 or len(steps) != 1 or loaded is None or not trees_equal(
                loaded, saved):
            fail(f"{label} --restart at bf16 did not resume at step 2 with "
                 "the saved state")
        if launches[0] == 0 or checked[0] != launches[0]:
            fail(f"{label} --restart at bf16: {launches} kernel launches, "
                 f"{checked[0]} of them checked")
        floats = [v for v in _flat_tensors(restore_checkpoint(run, 3))
                  if v.is_floating_point()]
        if not floats or any(v.dtype != torch.float32 for v in floats):
            fail(f"{label} at bf16: the checkpoint is not f32")
        out[label] = (step_medians(steps), launches, worst[0])
        log(f"command line at bf16: {label}, 2 steps, a checkpoint, then a "
            f"restart at 2 for one more (weights, optimizer states and the "
            f"step as saved, f32 checkpoints); the restart's "
            f"{launches[0]} snake+conv launches ({checked[0]} held to their "
            f"plain versions, worst {worst[0]:.3e} of max |y|)")
    return out


def _flat_tensors(tree):
    import torch
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _flat_tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def bf16_train_phase(row) -> list:
    """Phase 17: bf16 training (see the module docstring).  Returns the
    kernel table's rows of the bf16 backward kernels."""
    import torch
    enc, launches16, medians, peak = bf16_codec_training()
    phase_time("phase 17a (bf16 codec training)")
    bwd = check_gradients_bf16(enc, 8)
    phase_time("phase 17b (bf16 backward kernels)")
    loss, grads = bf16_train_card_vs_cpu()
    phase_time("phase 17c (bf16 training card vs CPU)")
    diff_medians, diff_peak = bf16_diffusion_training()
    phase_time("phase 17d (bf16 diffusion training)")
    cli = bf16_cli()
    phase_time("phase 17e (bf16 commands)")
    row["bf16_training"] = {
        "codec_step_ms_median": medians,
        "codec_peak_memory_gib": peak / 2**30,
        "card_vs_cpu_loss": loss,
        "card_vs_cpu_grad": {m: g[0] for m, g in grads.items()},
        "diffusion_step_ms_median": {f"{k}/{v}": ms for (k, v), ms in
                                     diff_medians.items()},
        "diffusion_peak_memory_gib": diff_peak / 2**30}
    torch.cuda.empty_cache()
    return [bf16_backward_row(kind, bwd, n)
            for kind, n in zip(("dgrad", "wgrad"), launches16)]


def alternatives_phase(row, requests, short) -> None:
    """Phase 18: EDM, Denoiser v1 and the conv UNet at the base preset's
    widths (see the module docstring); ``requests`` are phase 4's and
    ``short`` phase 5's clip (a, b, x0, the base model's CPU output)."""
    import numpy as np
    import torch
    from after_tpu_torch import TransferPipeline, get_config
    from after_tpu_torch.config import with_overrides
    from after_tpu_torch.dataset import DeviceLatentBank
    from after_tpu_torch.diffusion.edm import EDM
    from after_tpu_torch.diffusion.trainer import DiffusionTrainer
    from after_tpu_torch.ops.kernels.fused_conv import (device_launches,
                                                        fused_snake_conv,
                                                        reset_device_launches)
    from after_tpu_torch.streaming import Streamer
    from torch.nn.modules.module import register_module_forward_hook

    a, b = requests[1]
    kw = dict(nb_steps=NB_STEPS, guidance_timbre=GUIDANCE_TIMBRE)
    launches_by_model = {}
    for name, overrides in ALT_MODELS:
        cfg = with_overrides(get_config("base"), overrides)
        cfg = cfg.resolved(in_size=cfg.autoencoder.z_channels,
                           n_signal=N_SAMPLES // cfg.autoencoder.ratio)
        pipe = TransferPipeline(cfg, device="cuda").init(SEED)
        if (name == "edm") != isinstance(pipe.rf, EDM):
            fail(f"{name}: make_model built {type(pipe.rf).__name__}")
        n_net = sum(p.numel() for p in pipe.rf.net.parameters())

        def noise():
            return torch.Generator("cuda").manual_seed(SEED)

        # the transfer as a CUDA graph: warm-up and capture, then replays
        # with the device's counts set to 0 just before and read just after
        t0 = time.perf_counter()
        pipe.transfer(a, b, **kw, generator=noise())
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        pause_background()
        reset_device_launches()
        times, outs = [], []
        for _ in range(ALT_TRANSFERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(pipe.transfer(a, b, **kw, generator=noise()))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = device_launches()[0]
        resume_background()
        if launches != 96 * ALT_TRANSFERS:
            fail(f"{name}: the device counted {launches} {KERNEL_NAME} "
                 f"launches in {ALT_TRANSFERS} replayed transfers, expected "
                 f"96 a transfer")
        launches_by_model[name] = launches // ALT_TRANSFERS
        y = outs[-1]
        if not torch.isfinite(y).all() or y.shape[1] < N_SAMPLES:
            fail(f"{name}: transfer output {tuple(y.shape)}, finite "
                 f"{bool(torch.isfinite(y).all())}")
        # op by op, every launch held to the op's plain version
        pipe.eager = True
        worst, checked = [0.0], [0]
        hook = register_module_forward_hook(
            snake_conv_check(f"{name} transfer", worst, checked))
        fused_snake_conv.launches = 0
        reset_device_launches()
        eager_out = pipe.transfer(a, b, **kw, generator=noise())
        eager_launches = device_launches()[0]
        hook.remove()
        if (checked[0], fused_snake_conv.launches, eager_launches) != (
                96, 96, 96):
            fail(f"{name}: op by op, {checked[0]} launches checked, "
                 f"{fused_snake_conv.launches} wrapper calls, "
                 f"{eager_launches} counted on the device; expected 96")
        pause_background()
        eager_times = []
        for _ in range(ALT_TRANSFERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.transfer(a, b, **kw, generator=noise())
            torch.cuda.synchronize()
            eager_times.append(time.perf_counter() - t0)
        resume_background()
        pipe.eager = False
        agree(f"alternatives {name}: transfer graph vs op by op", y,
              eager_out)
        med, eager_med = (sorted(t)[len(t) // 2] * 1e3
                          for t in (times, eager_times))
        log(f"alternatives {name}: denoiser {type(pipe.rf.net).__name__} "
            f"({n_net} parameters), {type(pipe.rf).__name__}; a "
            f"{N_SAMPLES}-sample transfer at {NB_STEPS} steps: first call "
            f"{first_ms:.1f} ms (warm-up and capture), median {med:.2f} ms "
            f"as a CUDA graph, {eager_med:.2f} ms op by op; {KERNEL_NAME} "
            f"launches counted on the device {launches // ALT_TRANSFERS} a "
            f"transfer; op by op {checked[0]} launches held to the plain "
            f"version, worst {worst[0]:.3e} x max|y|; card {card_line()}")

        # card vs CPU on phase 5's clip
        cpu = TransferPipeline(cfg, device="cpu")
        cpu.codec.load_state_dict(pipe.codec.state_dict())
        cpu.rf.load_state_dict(pipe.rf.state_dict())
        sa, sb, x0, _ = short
        skw = dict(nb_steps=SHORT_STEPS, guidance_timbre=GUIDANCE_TIMBRE,
                   x0=x0)
        y_card = pipe.transfer(sa, sb, **skw).cpu()
        y_cpu = cpu.transfer(sa, sb, **skw)
        err = (y_card - y_cpu).abs().max().item()
        scale = y_cpu.abs().max().item()
        log(f"alternatives {name}: card vs CPU, {SHORT_SAMPLES} samples, "
            f"{SHORT_STEPS} steps, max abs err {err:.3e}, max |y| "
            f"{scale:.4f}, tolerance {CARD_VS_CPU_TOL} * max |y| = "
            f"{CARD_VS_CPU_TOL * scale:.3e}")
        if not (torch.isfinite(y_card).all() and err <= CARD_VS_CPU_TOL
                * scale):
            fail(f"{name}: card and CPU disagree")
        del cpu

        if name in ("edm", "v1"):
            streamer = Streamer(cfg, CHUNK, N_FADE, pipeline=pipe)
            state = streamer.init_state(1)
            A = streamer.audio_chunk
            n = ALT_STREAM_BUFFERS * A
            x0s = np.random.RandomState(SEED + 18).randn(
                ALT_STREAM_BUFFERS, 1, CHUNK,
                cfg.denoiser.n_channels).astype(np.float32)
            captures = streamer.graphs.captures
            pause_background()
            reset_device_launches()
            stimes, _ = stream_audio(streamer, state, a[:, :n], b[:, :n],
                                     ALT_STREAM_STEPS, x0s=x0s)
            slaunches = device_launches()[0]
            resume_background()
            if streamer.graphs.captures != captures:
                fail(f"{name}: the stream was captured again")
            if slaunches != 96 * ALT_STREAM_BUFFERS:
                fail(f"{name}: the device counted {slaunches} launches in "
                     f"{ALT_STREAM_BUFFERS} buffers, expected 96 a buffer")
            log(f"alternatives {name}: streaming, {ALT_STREAM_BUFFERS} "
                f"buffers of {A} samples at nb_steps {ALT_STREAM_STEPS}, "
                f"median / p90 / max ms a buffer as CUDA graphs "
                f"{spread(stimes)}; {slaunches // ALT_STREAM_BUFFERS} "
                f"launches a buffer counted on the device; card "
                f"{card_line()}")
            del streamer, state
        else:
            try:
                Streamer(cfg, CHUNK, N_FADE, pipeline=pipe)
                fail("unet1d: the streamer took an offline-only backbone")
            except ValueError as e:
                log(f"alternatives {name}: the streamer refuses it ({e})")
        del pipe
        gc.collect()
        torch.cuda.empty_cache()

    # EDM training: a few graphed steps of fit, phase-2 then cycle
    cfg = diffusion_config(**ALT_TRAIN_SCHEDULE, diffusion_type="edm")
    tr = DiffusionTrainer(cfg, device="cuda", seed=SEED).init(SEED)
    kinds = [tr.step_kind(i) for i in range(len(ALT_TRAIN_KINDS))]
    if kinds != ALT_TRAIN_KINDS or not isinstance(tr.rf, EDM):
        fail(f"EDM training: schedule {kinds}, model {type(tr.rf).__name__}")
    items = [{"z": z} for z in synthetic_latents(
        DIFF_RECORDS, cfg.denoiser.n_channels, DIFF_RECORD_FRAMES, SEED)]
    bank = DeviceLatentBank(items, DIFF_FRAMES, device="cuda")
    steps = []

    def callback(t, metrics):
        torch.cuda.synchronize()
        steps.append((t.step - 1, time.perf_counter() - clock[0],
                      {k: float(v) for k, v in metrics.items()}))
        clock[0] = time.perf_counter()

    pause_background()
    torch.cuda.synchronize()
    clock = [time.perf_counter()]
    tr.fit(bank.batches(DIFF_BATCH, seed=SEED),
           max_steps=len(ALT_TRAIN_KINDS), callback=callback)
    resume_background()
    if len(steps) != len(ALT_TRAIN_KINDS) or not all(
            math.isfinite(v) for _, _, m in steps for v in m.values()):
        fail(f"EDM training: {len(steps)} steps, metrics "
             f"{[m for _, _, m in steps]}")
    if tr.graphs is None or tr.graphs.captures != 2 or any(
            m.get("skipped_nonfinite", 0) for _, _, m in steps):
        fail(f"EDM training: {tr.graphs.captures if tr.graphs else 0} "
             f"captures (expected 2: phase 2 and cycle), skipped updates "
             f"{[m.get('skipped_nonfinite') for _, _, m in steps]}")
    log("alternatives edm: training, base + cycle at batch "
        f"{DIFF_BATCH} x {DIFF_FRAMES} frames, steps as CUDA graphs "
        + ", ".join(f"{i} {k} {dt * 1e3:.1f} ms loss {m['loss']:.4f}"
                    f" diffusion {m['diffusion_loss']:.4f} cycle "
                    f"{m['cycle_cond']:.4f}"
                    for (i, dt, m), k in zip(steps, ALT_TRAIN_KINDS))
        + f"; card {card_line()}")
    row["launches_alternatives"] = launches_by_model
    del tr, bank
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_snake_conv():
    """While in the block, every offline ``ConvBlock1d`` runs the
    snake+conv's plain version (``snake_conv_reference``) in place of the
    op, so that a float64 codec runs on the card (the kernels take f32 and
    bf16 only) as the witness of the f32 runs; no kernel launches."""
    from after_tpu_torch.models.autoencoder import ConvBlock1d
    from after_tpu_torch.ops.kernels.fused_conv import snake_conv_reference
    forward = ConvBlock1d.forward

    def plain(self, x, cache=None):
        if self.cached:
            return forward(self, x, cache)
        h = self.gn(x, cache) if self.gn is not None else x
        return snake_conv_reference(
            h.contiguous(), self.act.alpha, self.act.beta,
            self.conv.effective_weight(), self.conv.bias, self.conv.dilation,
            self.conv.mode)
    ConvBlock1d.forward = plain
    try:
        yield
    finally:
        ConvBlock1d.forward = forward


def codec_step_grads(ae, dcfg, tc, state, device: str, x, use_gan: bool,
                     weights, noise, decoder_noise, double: bool = False):
    """One generator step's metrics and codec gradients (float64, on the
    CPU) of an ``AutoencoderTrainer`` of (ae, tc, dcfg) on ``device`` whose
    codec and discriminator load ``state`` (their two state dicts), with
    fixed batch ``x``, bottleneck ``noise`` and ``decoder_noise`` (numpy);
    with ``double`` both models and every input in float64, the snake+conv
    by its plain version (``plain_snake_conv``)."""
    import torch
    from after_tpu_torch.autoencoder import AutoencoderTrainer
    tr = AutoencoderTrainer(ae, tc, dcfg, device=device)
    tr.codec.load_state_dict(state[0])
    tr.disc.load_state_dict(state[1])
    run = contextlib.nullcontext()
    if double:
        tr.codec.double()
        tr.disc.double()
        tr._tensor = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                               device=tr.device)
        run = plain_snake_conv()
    with run:
        metrics, grads = tr.gen_grads(x, use_gan, *weights, noise,
                                      decoder_noise)
    names = [n for n, _ in tr.codec.named_parameters()]
    return ({k: float(v) for k, v in metrics.items()},
            [g.detach().double().cpu() for g in grads], names)


def grad_distance(names, grads, ref):
    """(worst, its tensor's name, median) over tensors of |grads - ref|'s
    max over the larger of the tensor's max |ref| and 1e-3 x the largest
    |ref| of the model (phase 9's measure)."""
    floor = 1e-3 * max(g.abs().max().item() for g in ref)
    ratios = sorted(((a - b).abs().max().item()
                     / max(b.abs().max().item(), floor), n)
                    for n, a, b in zip(names, grads, ref))
    return ratios[-1][0], ratios[-1][1], ratios[len(ratios) // 2][0]


def codec_step_witness(ae, dcfg, tc, state, step) -> dict:
    """Phase 19(a)'s check at the weights its training steps leave
    (``state``): one generator step (``step``: codec_step_grads's batch,
    use_gan, weights, bottleneck and decoder noise) on the card and on the
    CPU in f32, each against the same step in float64 on the card
    (``codec_step_grads``).  The MR-STFT's log-magnitude term divides by
    |Y| on the reconstruction's near-silent bins, where the f32 spectrum is
    rounding, so with it the f32 gradients of either device stand 1e-3-1e-1
    x max|g| from float64, the card as often nearer as farther than the
    CPU (ROADMAP C13, scripts/torch_codec_step_conditioning.py): that
    reading is printed, its losses held within CARD_VS_CPU_TOL.  Without
    that term (``stft_w_log_mag`` 0), where f32 resolves the gradients,
    the card is held to float64 within phase 9's limits: the check of the
    kernels' path at these weights.  Returns the readings."""
    import dataclasses
    n = tc.num_signal
    out = {}
    for label, log_mag in (("with", True), ("without", False)):
        ctc = tc if log_mag else dataclasses.replace(tc, stft_w_log_mag=0.0)
        card = codec_step_grads(ae, dcfg, ctc, state, "cuda", *step)
        exact = codec_step_grads(ae, dcfg, ctc, state, "cuda", *step,
                                 double=True)
        names = card[2]
        reading = {"card_vs_f64": grad_distance(names, card[1], exact[1])}
        if log_mag:
            cpu = codec_step_grads(ae, dcfg, ctc, state, "cpu", *step)
            reading["cpu_vs_f64"] = grad_distance(names, cpu[1], exact[1])
            reading["card_vs_cpu"] = grad_distance(names, card[1], cpu[1])
        reading["loss_vs_f64"] = max(
            abs(card[0][k] - v) / max(abs(v), 1e-2)
            for k, v in exact[0].items())
        out[label] = reading
        log(f"codec alternatives at the trained weights, {label} the "
            f"MR-STFT's log-magnitude term: one GAN generator step at {n} "
            f"samples, fixed bottleneck and decoder noise, codec gradients "
            "(x max(max|g|, 1e-3 x the model's largest)) worst (tensor), "
            "median: " + "; ".join(
                f"{k.replace('_', ' ')} {v[0]:.3e} ({v[1]}), {v[2]:.3e}"
                for k, v in reading.items() if k != "loss_vs_f64")
            + f"; card losses within {reading['loss_vs_f64']:.3e} x "
            f"max(|loss|, 0.01) of float64")
    if out["with"]["loss_vs_f64"] > CARD_VS_CPU_TOL:
        fail(f"codec alternatives: at the trained weights the card's losses "
             f"stand {out['with']['loss_vs_f64']:.3e} from float64")
    worst, name, median = out["without"]["card_vs_f64"]
    if (worst > TRAIN_GRAD_TOL["codec"] or median > TRAIN_GRAD_MEDIAN_TOL
            or out["without"]["loss_vs_f64"] > CARD_VS_CPU_TOL):
        fail(f"codec alternatives: at the trained weights without the "
             f"log-magnitude term the card stands {worst:.3e} ({name}; "
             f"limit {TRAIN_GRAD_TOL['codec']}), median {median:.3e} (limit "
             f"{TRAIN_GRAD_MEDIAN_TOL}) from float64")
    return out


def codec_alternatives_phase(row, requests, short) -> None:
    """Phase 19: the descript discriminator, the decoder's NoiseGenerator
    and the VAE encoders at base widths (see the module docstring);
    ``requests`` are phase 4's and ``short`` phase 5's clip."""
    import numpy as np
    import torch
    from after_tpu_torch import TransferPipeline, get_config
    from after_tpu_torch.autoencoder import AutoencoderTrainer
    from after_tpu_torch.config import (AETrainConfig, DiscriminatorConfig,
                                        get_ae_config, with_overrides)
    from after_tpu_torch.dataset import DeviceLatentBank
    from after_tpu_torch.diffusion.trainer import DiffusionTrainer
    from after_tpu_torch.models.descript_discriminator import \
        DescriptDiscriminator
    from after_tpu_torch.ops.kernels.fused_conv import (
        backward_device_launches, device_launches, fused_snake_conv,
        reset_device_launches)
    from after_tpu_torch.streaming import Streamer
    from torch.nn.modules.module import register_module_forward_hook

    counts = {}

    # (a) codec training: the base codec with use_noise, the descript
    # discriminator at its default periods and FFT sizes, phase 8's batch
    ae = get_ae_config(use_noise=True)
    dcfg = DiscriminatorConfig(kind="descript")
    tc = AETrainConfig(warmup_steps=TRAIN_WARMUP)
    tr = AutoencoderTrainer(ae, tc, dcfg, device="cuda",
                            seed=SEED).init(SEED)
    if not isinstance(tr.disc, DescriptDiscriminator):
        fail(f"codec alternatives: the trainer built "
             f"{type(tr.disc).__name__}")
    gen = torch.Generator("cuda").manual_seed(SEED + 19)
    x = synthetic_audio(gen, tc.batch_size, tc.num_signal, ae.sr)
    w_gan = tr._recon_weights(TRAIN_WARMUP + 1)
    steps = ([("warmup", lambda: tr.gen_step(x, False, *tr._recon_weights(
        0)))] * CODEC_ALT_WARMUP + [
        ("gan", lambda: tr.gen_step(x, True, *w_gan)),
        ("disc", lambda: tr.disc_step(x))] * CODEC_ALT_STEPS)
    records = []
    pause_background()
    for kind, step in steps:
        reset_device_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = (device_launches()[0], *backward_device_launches()[:2])
        values = {k: float(v) for k, v in metrics.items()}
        records.append((kind, dt, launches, values))
        want = (64, 64, 64) if kind != "disc" else (64, 0, 0)
        if launches != want:
            fail(f"codec alternatives: a {kind} step launched (forward, "
                 f"dgrad, wgrad) {launches} on the device, expected {want}")
        if not all(math.isfinite(v) for v in values.values()) or values.get(
                "skipped_nonfinite", 0):
            fail(f"codec alternatives: {kind} step metrics {values}")
    resume_background()
    med = {k: sorted(dt for kk, dt, *_ in records if kk == k)[
        len([1 for kk, *_ in records if kk == k]) // 2] * 1e3
        for k in ("gan", "disc")}
    gan = [r for r in records if r[0] == "gan"][-1][3]
    disc = [r for r in records if r[0] == "disc"][-1][3]
    n_disc = sum(p.numel() for p in tr.disc.parameters())
    log(f"codec alternatives: base codec with use_noise, descript "
        f"discriminator ({n_disc} parameters: periods "
        f"{dcfg.descript_periods}, FFT sizes {dcfg.descript_fft_sizes}), "
        f"batch {tc.batch_size} x {tc.num_signal}: warm-up generator steps "
        + ", ".join(f"{dt * 1e3:.1f}" for k, dt, *_ in records
                    if k == "warmup")
        + f" ms; median of {CODEC_ALT_STEPS} GAN generator steps "
        f"{med['gan']:.2f} ms, of {CODEC_ALT_STEPS} discriminator steps "
        f"{med['disc']:.2f} ms; (forward, dgrad, wgrad) launches counted on "
        f"the device (64, 64, 64) a generator step, (64, 0, 0) a "
        f"discriminator step; last GAN step total_loss "
        f"{gan['total_loss']:.4f} feature_matching "
        f"{gan['feature_matching']:.4f} adversarial {gan['adversarial']:.4f}"
        f", discriminator {disc['discriminator']:.4f}; card {card_line()}")
    counts["codec_gen_step"] = records[-2][2]
    counts["codec_disc_step"] = records[-1][2]
    row["codec_alternatives_step_ms"] = med
    trained = tuple({k: v.detach().cpu().clone() for k, v in
                     m.state_dict().items()} for m in (tr.codec, tr.disc))
    shape = tr.codec.decoder_noise_shape(1, TRAIN_VS_CPU_SAMPLES // ae.ratio)
    del tr, x
    # one GAN generator step at batch 1 with fixed batch, bottleneck and
    # decoder noise: at the weights the steps above leave, held to float64
    # (codec_step_witness); at the seed's weights, card against CPU as
    # phase 9 holds them
    ctc = AETrainConfig(warmup_steps=TRAIN_WARMUP, batch_size=1,
                        num_signal=TRAIN_VS_CPU_SAMPLES)
    xs = synthetic_audio(gen, 1, TRAIN_VS_CPU_SAMPLES, ae.sr).cpu().numpy()
    rng = np.random.RandomState(SEED + 19)
    bn = rng.randn(1, TRAIN_VS_CPU_SAMPLES // ae.ratio,
                   ae.z_channels).astype(np.float32)
    dn = rng.uniform(-1, 1, shape).astype(np.float32)
    step = (xs, True, w_gan, bn, dn)
    row["codec_alternatives_trained_vs_f64"] = codec_step_witness(
        ae, dcfg, ctc, trained, step)
    seeded = AutoencoderTrainer(ae, ctc, dcfg, device="cuda").init(SEED)
    seeded = tuple(m.state_dict() for m in (seeded.codec, seeded.disc))
    (cm, cg, names), (pm, pg, _) = (
        codec_step_grads(ae, dcfg, ctc, seeded, dev, *step)
        for dev in ("cuda", "cpu"))
    loss = max(abs(cm[k] - v) / max(abs(v), 1e-2) for k, v in pm.items())
    worst, name, median = grad_distance(names, cg, pg)
    log(f"codec alternatives card vs CPU: one GAN generator step at "
        f"{TRAIN_VS_CPU_SAMPLES} samples, the seed's weights, fixed "
        f"bottleneck and decoder noise: losses within {loss:.3e} x "
        f"max(|loss|, 0.01) (limit {CARD_VS_CPU_TOL}); codec gradients "
        f"worst {worst:.3e} ({name}; limit {TRAIN_GRAD_TOL['codec']}), "
        f"median {median:.3e} (limit {TRAIN_GRAD_MEDIAN_TOL})")
    if not (loss <= CARD_VS_CPU_TOL and worst <= TRAIN_GRAD_TOL["codec"]
            and median <= TRAIN_GRAD_MEDIAN_TOL):
        fail("codec alternatives: card and CPU disagree")
    del seeded
    gc.collect()
    torch.cuda.empty_cache()

    # (b) transfer with that codec in the base pipeline
    a, b = requests[1]
    kw = dict(nb_steps=NB_STEPS, guidance_timbre=GUIDANCE_TIMBRE)
    cfg = with_overrides(get_config("base"), {"autoencoder.use_noise": True})
    cfg = cfg.resolved(in_size=cfg.autoencoder.z_channels,
                       n_signal=N_SAMPLES // cfg.autoencoder.ratio)
    pipe = TransferPipeline(cfg, device="cuda").init(SEED)

    def noise():
        return torch.Generator("cuda").manual_seed(SEED)

    t0 = time.perf_counter()
    pipe.transfer(a, b, **kw, generator=noise())
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    pause_background()
    reset_device_launches()
    times, outs = [], []
    for _ in range(CODEC_ALT_TRANSFERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(pipe.transfer(a, b, **kw, generator=noise()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = device_launches()[0]
    resume_background()
    if launches != 96 * CODEC_ALT_TRANSFERS:
        fail(f"noise codec transfer: the device counted {launches} "
             f"launches in {CODEC_ALT_TRANSFERS} replays, expected 96 each")
    y = outs[-1]
    if not torch.isfinite(y).all() or y.shape[1] < N_SAMPLES:
        fail(f"noise codec transfer: output {tuple(y.shape)}")
    agree("codec alternatives: two transfers of the same request and x0 "
          "(the decoder's fixed noise)", outs[0], outs[1])
    pipe.eager = True
    worst, checked = [0.0], [0]
    hook = register_module_forward_hook(
        snake_conv_check("noise codec transfer", worst, checked))
    fused_snake_conv.launches = 0
    reset_device_launches()
    eager_out = pipe.transfer(a, b, **kw, generator=noise())
    eager_launches = device_launches()[0]
    hook.remove()
    if (checked[0], fused_snake_conv.launches, eager_launches) != (96, 96,
                                                                   96):
        fail(f"noise codec transfer op by op: {checked[0]} launches "
             f"checked, {fused_snake_conv.launches} wrapper calls, "
             f"{eager_launches} on the device; expected 96")
    pause_background()
    eager_times = []
    for _ in range(CODEC_ALT_TRANSFERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.transfer(a, b, **kw, generator=noise())
        torch.cuda.synchronize()
        eager_times.append(time.perf_counter() - t0)
    resume_background()
    pipe.eager = False
    agree("codec alternatives: noise codec transfer graph vs op by op", y,
          eager_out)
    tmed, emed = (sorted(t)[len(t) // 2] * 1e3 for t in (times,
                                                          eager_times))
    log(f"codec alternatives: a {N_SAMPLES}-sample transfer with the noise "
        f"codec at {NB_STEPS} steps: first call {first_ms:.1f} ms (warm-up "
        f"and capture), median {tmed:.2f} ms as a CUDA graph, {emed:.2f} ms "
        f"op by op; {launches // CODEC_ALT_TRANSFERS} launches a transfer "
        f"counted on the device; op by op {checked[0]} launches held to the "
        f"plain version, worst {worst[0]:.3e} x max|y|; card {card_line()}")
    counts["noise_transfer"] = launches // CODEC_ALT_TRANSFERS
    row["noise_transfer_ms"] = (tmed, emed)
    # card vs CPU on phase 5's clip, the CPU keeping the card's fixed draw
    cpu = TransferPipeline(cfg, device="cpu")
    cpu.codec.load_state_dict(pipe.codec.state_dict())
    cpu.rf.load_state_dict(pipe.rf.state_dict())
    sa, sb, x0, _ = short
    skw = dict(nb_steps=SHORT_STEPS, guidance_timbre=GUIDANCE_TIMBRE, x0=x0)
    y_card = pipe.transfer(sa, sb, **skw).cpu()
    shape = pipe.codec.decoder_noise_shape(1, x0.shape[1])
    kept = pipe.codec.decoder.noise.fixed[(shape, str(pipe.device))]
    cpu.codec.decoder.noise.keep_noise(kept.cpu())
    y_cpu = cpu.transfer(sa, sb, **skw)
    err = (y_card - y_cpu).abs().max().item()
    scale = y_cpu.abs().max().item()
    log(f"codec alternatives: noise codec card vs CPU, {SHORT_SAMPLES} "
        f"samples, {SHORT_STEPS} steps, the card's decoder noise kept on the"
        f" CPU: max abs err {err:.3e}, max |y| {scale:.4f}, tolerance "
        f"{CARD_VS_CPU_TOL} * max |y| = {CARD_VS_CPU_TOL * scale:.3e}")
    if not (torch.isfinite(y_card).all() and err <= CARD_VS_CPU_TOL * scale):
        fail("codec alternatives: the noise codec's card and CPU disagree")
    del cpu

    # (c) the crossfade streamer of that codec
    streamer = Streamer(cfg, CHUNK, N_FADE, pipeline=pipe)
    state = streamer.init_state(1)
    A = streamer.audio_chunk
    n = CODEC_ALT_BUFFERS * A
    x0s = np.random.RandomState(SEED + 19).randn(
        CODEC_ALT_BUFFERS, 1, CHUNK, cfg.denoiser.n_channels).astype(
            np.float32)
    captures = streamer.graphs.captures
    pause_background()
    reset_device_launches()
    stimes, _ = stream_audio(streamer, state, a[:, :n], b[:, :n],
                             ALT_STREAM_STEPS, x0s=x0s)
    slaunches = device_launches()[0]
    resume_background()
    if streamer.graphs.captures != captures:
        fail("noise codec stream: captured again")
    if slaunches != 96 * CODEC_ALT_BUFFERS:
        fail(f"noise codec stream: the device counted {slaunches} launches "
             f"in {CODEC_ALT_BUFFERS} buffers, expected 96 a buffer")
    log(f"codec alternatives: streaming the noise codec, "
        f"{CODEC_ALT_BUFFERS} buffers of {A} samples at nb_steps "
        f"{ALT_STREAM_STEPS}, median / p90 / max ms a buffer as CUDA graphs "
        f"{spread(stimes)}; {slaunches // CODEC_ALT_BUFFERS} launches a "
        f"buffer counted on the device; card {card_line()}")
    counts["noise_buffer"] = slaunches // CODEC_ALT_BUFFERS
    del streamer, state, pipe
    gc.collect()
    torch.cuda.empty_cache()

    # (d) diffusion training with both VAE encoders: graphed phase-2 steps
    dcfg2 = diffusion_config(**VAE_OVERRIDES)
    dtr = DiffusionTrainer(dcfg2, device="cuda", seed=SEED).init(SEED)
    items = [{"z": z} for z in synthetic_latents(
        DIFF_RECORDS, dcfg2.denoiser.n_channels, DIFF_RECORD_FRAMES, SEED)]
    bank = DeviceLatentBank(items, DIFF_FRAMES, device="cuda")
    batches = bank.batches(DIFF_BATCH, seed=SEED)
    flags, weights = (False, True, True, False), (0.1, 0.1)
    dtimes, dmetrics = [], []
    pause_background()
    for i in range(1 + VAE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = dtr.train_step(next(batches), *flags, *weights)
        torch.cuda.synchronize()
        dtimes.append(time.perf_counter() - t0)
        dmetrics.append({k: float(v) for k, v in m.items()})
    resume_background()
    if dtr.graphs is None or dtr.graphs.captures != 1 or not all(
            math.isfinite(v) for m in dmetrics for v in m.values()) or any(
            m["skipped_nonfinite"] for m in dmetrics):
        fail(f"VAE diffusion training: captures "
             f"{dtr.graphs.captures if dtr.graphs else 0}, metrics "
             f"{dmetrics}")
    log(f"codec alternatives: diffusion training with ECAPA "
        f"regularisation vae and Encoder1D vae + upscale_out, batch "
        f"{DIFF_BATCH} x {DIFF_FRAMES} frames: first phase-2 step (op by "
        f"op and capture) {dtimes[0] * 1e3:.1f} ms, {VAE_TRAIN_STEPS} "
        f"replayed steps " + ", ".join(f"{t * 1e3:.2f}" for t in dtimes[1:])
        + " ms; last step " + ", ".join(
            f"{k} {dmetrics[-1][k]:.4f}" for k in (
                "loss", "diffusion_loss", "cond_reg", "time_cond_reg"))
        + f"; card {card_line()}")
    row["vae_step_ms"] = [t * 1e3 for t in dtimes[1:]]
    row["launches_codec_alternatives"] = counts
    del dtr, bank, batches
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")

    import numpy as np
    from after_tpu_torch import TransferPipeline, get_config
    from after_tpu_torch.models.autoencoder import ConvBlock1d
    from after_tpu_torch.streaming import Streamer
    from after_tpu_torch.ops.kernels.build import load_all
    from after_tpu_torch.ops.kernels.fused_conv import (BACKWARD_SOURCE,
                                                        SOURCE,
                                                        device_launches,
                                                        fused_snake_conv,
                                                        reset_device_launches)
    from after_tpu_torch.utils.device import strict_f32

    phase_time("start")
    # 1. card
    log(f"card: {card_line()}")
    log(f"card: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build: every kernel source at once, an nvcc each
    t0 = time.perf_counter()
    load_all(SOURCE, BACKWARD_SOURCE)
    log(f"build: {SOURCE} and {BACKWARD_SOURCE} in "
        f"{time.perf_counter() - t0:.2f} s")

    cfg = get_config("base")
    cfg = cfg.resolved(in_size=cfg.autoencoder.z_channels,
                       n_signal=N_SAMPLES // cfg.autoencoder.ratio)
    t0 = time.perf_counter()
    pipe = TransferPipeline(cfg, device="cuda").init(SEED)
    torch.cuda.synchronize()
    log(f"serving: base config, port-native init (seed {SEED}) in "
        f"{time.perf_counter() - t0:.2f} s")

    phase_time("phase 1-2 (card, build)")

    # 3. kernels against their plain versions at the main paths' shapes:
    # a transfer (two encodes, one decode) and a streamed buffer (two
    # encodes and one decode of a window of n_fade + chunk latent frames)
    enc, dec = codec_conv_blocks(pipe.codec, N_SAMPLES)
    path = enc + enc + dec
    path_counts = Counter(block_shape(b, T) for b, T in path)
    window = (N_FADE + CHUNK) * cfg.autoencoder.ratio
    enc_w, dec_w = codec_conv_blocks(pipe.codec, window)
    stream_path = enc_w + enc_w + dec_w
    with torch.no_grad():
        per_transfer = check_fused_conv(path, "transfer")
        per_buffer = check_fused_conv(stream_path, "buffer")
    row = kernel_row(per_transfer, per_buffer)
    srow = sum_row(per_transfer, per_buffer)

    phase_time("phase 3 (kernels)")

    # 4. serving: the transfer as one CUDA graph (the main path), then the
    # same requests op by op; peak memory from here.  The kernel phase's
    # CUDA graphs leave garbage behind that slowed the serving phase's host
    # time when left for the collector.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(SEED)
    requests = [(0.1 * rng.randn(1, N_SAMPLES, 1).astype(np.float32),
                 0.1 * rng.randn(1, N_SAMPLES, 1).astype(np.float32))
                for _ in range(N_REQUESTS + 1)]
    expected_len = N_SAMPLES + (0 if cfg.autoencoder.causal
                                else cfg.autoencoder.pqmf_bands)
    kw = dict(nb_steps=NB_STEPS, guidance_timbre=GUIDANCE_TIMBRE)

    def hook_blocks(codec, seen):
        return [m.register_forward_pre_hook(lambda mod, args: seen.update(
            [block_shape(mod, args[0].shape[1])]))
            for m in codec.modules() if isinstance(m, ConvBlock1d)]

    # the first request warms up, captures and replays once: the hooks and
    # the wrapper's Python count see the warm-up and the capture (a replay
    # runs no Python), the device's count the warm-up and the replay
    seen = Counter()
    hooks = hook_blocks(pipe.codec, seen)
    fused_snake_conv.launches = 0
    reset_device_launches()
    t0 = time.perf_counter()
    pipe.transfer(*requests[0], **kw)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    for h in hooks:
        h.remove()
    first_device = device_launches()[0]
    if fused_snake_conv.launches != 2 * len(path) or first_device != 2 * len(
            path):
        fail(f"the first request called the kernel's wrapper "
             f"{fused_snake_conv.launches} times and the device counted "
             f"{first_device} launches, expected {2 * len(path)} each")
    if seen != Counter({s: 2 * n for s, n in path_counts.items()}):
        fail("the ConvBlock1d shapes of the warm-up and the capture differ "
             "from the checked ones")
    log(f"serving: first request {first_ms:.2f} ms (warm-up, capture in "
        f"{pipe.graphs.capture_seconds * 1e3:.1f} ms, one replay); the "
        f"warm-up and the capture called the kernel's wrapper "
        f"{fused_snake_conv.launches} times, the device counted "
        f"{first_device} launches (the warm-up's and the replay's); the "
        f"warm-up's and the capture's ConvBlock1d shapes are the checked ones")

    # the main path: 3 requests replayed, the device's launch counts set
    # to 0 just before them and read just after
    fused_snake_conv.launches = 0
    captures, replays = pipe.graphs.captures, pipe.graphs.replays
    times, outs = [], []
    reset_device_launches()
    for i, (a, b) in enumerate(requests[1:]):
        t0 = time.perf_counter()
        y = pipe.transfer(a, b, **kw,
                          generator=torch.Generator("cuda").manual_seed(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(y)
    launches, sums = device_launches()
    for i, y in enumerate(outs):
        if tuple(y.shape) != (1, expected_len, 1):
            fail(f"request {i}: output shape {tuple(y.shape)}")
        if not torch.isfinite(y).all():
            fail(f"request {i}: non-finite output")
        log(f"serving: request {i}: {times[i] * 1e3:.2f} ms, shape "
            f"{tuple(y.shape)}, rms {y.pow(2).mean().sqrt().item():.4f}")
    if launches != N_REQUESTS * len(path):
        fail(f"the device counted {launches} {KERNEL_NAME} launches in "
             f"{N_REQUESTS} transfers, expected {len(path)} a transfer")
    if fused_snake_conv.launches:
        fail("a replayed transfer called the kernel's wrapper")
    if pipe.graphs.captures != captures:
        fail("the transfer was captured again")
    graph_calls = (pipe.graphs.replays - replays) / N_REQUESTS
    log(f"serving: the device counted {launches} {KERNEL_NAME} and {sums} "
        f"{SUM_NAME} launches in the {N_REQUESTS} replayed transfers "
        f"({launches // N_REQUESTS} and {sums // N_REQUESTS} a transfer)")
    # launches in the main path's run (3 requests), counted on the device;
    # ms, plain_ms, bound_ms and library_ms are per transfer (96 launches)
    row["launches"] = launches
    row["launches_per_transfer"] = launches // N_REQUESTS
    row["sum_splits_launches_per_transfer"] = sums // N_REQUESTS
    srow["launches"] = sums
    if sums != N_REQUESTS * srow["launches_per_transfer"]:
        fail(f"the device counted {sums} {SUM_NAME} launches in "
             f"{N_REQUESTS} transfers, phase 3 expects "
             f"{srow['launches_per_transfer']} a transfer")
    row["graph_launches_per_transfer"] = graph_calls
    audio_s = N_SAMPLES / cfg.sr

    # the same requests op by op, on the same pipeline
    pipe.eager = True
    pipe.transfer(*requests[0], **kw)                     # warm-up
    seen.clear()
    hooks = hook_blocks(pipe.codec, seen)
    fused_snake_conv.launches = 0
    reset_device_launches()
    eager_times, eager_outs = [], []
    for i, (a, b) in enumerate(requests[1:]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_outs.append(pipe.transfer(
            a, b, **kw, generator=torch.Generator("cuda").manual_seed(i)))
        torch.cuda.synchronize()
        eager_times.append(time.perf_counter() - t0)
    for h in hooks:
        h.remove()
    if (fused_snake_conv.launches != N_REQUESTS * len(path)
            or device_launches() != (launches, sums)):
        fail(f"eager transfers called the kernel's wrapper "
             f"{fused_snake_conv.launches} times and the device counted "
             f"{device_launches()} launches")
    if seen != Counter({s: N_REQUESTS * n for s, n in path_counts.items()}):
        fail("the ConvBlock1d shapes of the eager path differ from the "
             "checked ones")
    pipe.eager = False
    med, eager_med = (sorted(t)[len(t) // 2] for t in (times, eager_times))
    log(f"serving: {N_REQUESTS} requests, median {med * 1e3:.2f} ms per "
        f"transfer as a CUDA graph ({graph_calls:g} graph launch a transfer;"
        f" real-time factor {audio_s / med:.2f}x), {eager_med * 1e3:.2f} ms "
        f"op by op ({audio_s / eager_med:.2f}x; {audio_s:.3f} s of audio)")
    agree(f"serving: graph vs eager, {N_REQUESTS} transfers of the same "
          "requests and noise", outs, eager_outs)
    pipe.eager = True
    agree("serving: eager vs eager, request 0 again", pipe.transfer(
        *requests[1], **kw, generator=torch.Generator("cuda").manual_seed(0)),
        eager_outs[0])
    pipe.eager = False
    row["transfer_ms_median"] = med * 1e3
    row["transfer_eager_ms_median"] = eager_med * 1e3
    ref_outs = outs                      # phase 16's f32 reference

    # per-phase times of one more transfer, through the same entry points,
    # as graphs and op by op (each phase run once before, to capture it)
    a, b = requests[1]

    def phase_times():
        phases = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            phases[name] = (time.perf_counter() - t) * 1e3
            return out

        z_s = timed("encode_structure_audio", lambda: pipe.encode(a))
        z_t = timed("encode_timbre_audio", lambda: pipe.encode(b))
        tc = timed("structure", lambda: pipe.structure(z_s))
        c = timed("timbre", lambda: pipe.timbre(z_t))
        x0 = torch.randn(z_s.shape, generator=torch.Generator("cuda")
                         .manual_seed(0), device="cuda")
        z = timed("sample", lambda: pipe.diffuse(
            x0, c, tc, NB_STEPS, GUIDANCE_TIMBRE))
        timed("decode", lambda: pipe.decode(z))
        return phases

    for eager in (False, True):
        pipe.eager = eager
        phase_times()
        phases = phase_times()
        log(f"serving: phases {'op by op' if eager else 'as CUDA graphs'} "
            f"(ms) " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
            + f", sum {sum(phases.values()):.2f}")
    pipe.eager = False
    log(f"serving: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    held = pipe.graphs.held_bytes()
    log(f"serving: the pipeline's graph pool holds "
        + (f"{held / 2**20:.1f} MiB" if held is not None else "not measured")
        + f" ({pipe.graphs.captures} graphs: the transfer, the phases and "
        f"phase 5's keys to come; capture time so far "
        f"{pipe.graphs.capture_seconds * 1e3:.1f} ms)")
    _, _, counts, ms = profile_call("one transfer as a CUDA graph",
                                    lambda: pipe.transfer(a, b, **kw))
    replay_witness("one replayed transfer", counts, ms,
                   launches // N_REQUESTS, sums // N_REQUESTS, row,
                   "transfer")
    pipe.eager = True
    profile_call("one transfer op by op", lambda: pipe.transfer(a, b, **kw))
    no_host_sync("one transfer op by op", lambda: pipe.transfer(a, b, **kw))
    pipe.eager = False

    phase_time("phase 4 (serving)")

    # 5. card vs CPU on a short clip, same weights, through the graphs
    cpu = TransferPipeline(cfg, device="cpu")
    cpu.codec.load_state_dict(pipe.codec.state_dict())
    cpu.rf.load_state_dict(pipe.rf.state_dict())
    rng = np.random.RandomState(SEED + 1)
    a = 0.1 * rng.randn(1, SHORT_SAMPLES, 1).astype(np.float32)
    b = 0.1 * rng.randn(1, SHORT_SAMPLES, 1).astype(np.float32)
    x0 = rng.randn(1, SHORT_SAMPLES // cfg.autoencoder.ratio,
                   cfg.autoencoder.z_channels).astype(np.float32)
    kw = dict(nb_steps=SHORT_STEPS, guidance_timbre=GUIDANCE_TIMBRE, x0=x0)
    y_card = pipe.transfer(a, b, **kw).cpu()
    y_cpu = cpu.transfer(a, b, **kw)
    err = (y_card - y_cpu).abs().max().item()
    scale = y_cpu.abs().max().item()
    # the same run with TF32 allowed in cuBLAS and cuDNN (a graph captured
    # under those switches): the reading a precision leak would give, for
    # the record beside the strict one
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    err_tf32 = (pipe.transfer(a, b, **kw).cpu() - y_cpu).abs().max().item()
    strict_f32()
    log(f"card vs CPU: {SHORT_SAMPLES} samples, {SHORT_STEPS} steps, the card "
        f"through its CUDA graph, max abs err {err:.3e} (with TF32 allowed: "
        f"{err_tf32:.3e}), max |y| {scale:.4f}, tolerance {CARD_VS_CPU_TOL} "
        f"* max |y| = {CARD_VS_CPU_TOL * scale:.3e}")
    if not (torch.isfinite(y_card).all() and err <= CARD_VS_CPU_TOL * scale):
        fail("card and CPU disagree")
    short = (a, b, x0, y_cpu)            # for phase 16

    phase_time("phase 5 (card vs CPU)")

    # 6. streaming: phase 4's first request, buffer by buffer, as CUDA
    # graphs and op by op on the same weights and noise
    streamer = Streamer(cfg, chunk_size=CHUNK, n_fade=N_FADE, pipeline=pipe)
    eager_streamer = Streamer(cfg, chunk_size=CHUNK, n_fade=N_FADE,
                              pipeline=pipe, eager=True)
    a, b = requests[1]
    A = streamer.audio_chunk
    buffer_ms = A / cfg.sr * 1e3
    for st in (streamer, eager_streamer):                  # warm-up
        stream_audio(st, st.init_state(1), a[:, :STREAM_WARMUP * A],
                     b[:, :STREAM_WARMUP * A], STREAM_STEPS[-1])
    n_buffers = N_SAMPLES // A
    x0s = np.random.RandomState(SEED + 6).randn(
        n_buffers, 1, CHUNK, cfg.denoiser.n_channels).astype(np.float32)
    want = Counter({s: n_buffers * n for s, n in Counter(
        block_shape(blk, T) for blk, T in stream_path).items()})
    # init_state: the pass that builds the caches (one encode and one
    # decode of a window), the warm-up and the capture (a buffer each)
    want_init = Counter(block_shape(blk, T)
                        for blk, T in stream_path + stream_path + enc_w
                        + dec_w)
    S = cfg.denoiser.max_diffusion_steps
    launches_streaming = sums_streaming = 0
    stream_rows = {}
    for nb in STREAM_STEPS:
        # init_state: the hooks and the wrapper's Python count see its
        # cache pass, warm-up and capture, one call of the kernel a hook
        seen.clear()
        hooks = hook_blocks(streamer.codec, seen)
        captures = streamer.graphs.captures
        fused_snake_conv.launches = 0
        t0 = time.perf_counter()
        state = streamer.init_state(1)
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t0) * 1e3
        for h in hooks:
            h.remove()
        if streamer.graphs.captures - captures != 3 + S:
            fail(f"init_state captured {streamer.graphs.captures - captures}"
                 f" graphs, expected {3 + S}")
        if seen != want_init:
            fail("the ConvBlock1d shapes of the stream's warm-up and capture "
                 "differ from the checked ones")
        if fused_snake_conv.launches != sum(want_init.values()):
            fail(f"init_state called the kernel's wrapper "
                 f"{fused_snake_conv.launches} times for "
                 f"{sum(want_init.values())} ConvBlock1d calls")
        # the streamed path: the device's launch counts set to 0 just
        # before its 64 buffers and read just after
        fused_snake_conv.launches = 0
        captures, replays = streamer.graphs.captures, streamer.graphs.replays
        reset_device_launches()
        times, ys = stream_audio(streamer, state, a, b, nb, x0s=x0s)
        launches, sums = device_launches()
        launches_streaming += launches
        sums_streaming += sums
        if launches != len(stream_path) * n_buffers:
            fail(f"streaming: the device counted {launches} {KERNEL_NAME} "
                 f"launches in {n_buffers} buffers, expected "
                 f"{len(stream_path)} a buffer")
        if fused_snake_conv.launches:
            fail("a replayed buffer called the kernel's wrapper")
        if streamer.graphs.captures != captures:
            fail("a stream state was captured again")
        graph_calls = (streamer.graphs.replays - replays) / n_buffers
        e_state = eager_streamer.init_state(1)
        seen.clear()
        hooks = hook_blocks(eager_streamer.codec, seen)
        fused_snake_conv.launches = 0
        reset_device_launches()
        eager_times, eager_ys = stream_audio(eager_streamer, e_state, a, b, nb,
                                             x0s=x0s)
        for h in hooks:
            h.remove()
        if (fused_snake_conv.launches != len(stream_path) * n_buffers
                or device_launches() != (launches, sums)):
            fail(f"streaming op by op: the kernel's wrapper was called "
                 f"{fused_snake_conv.launches} times and the device counted "
                 f"{device_launches()} launches")
        if seen != want:
            fail("the ConvBlock1d shapes of the streaming path differ from "
                 "the checked ones")
        med, eager_med = (sorted(t)[len(t) // 2] for t in (times,
                                                           eager_times))
        stream_rows[nb] = (med * 1e3, eager_med * 1e3)
        log(f"streaming: nb_steps {nb}, {n_buffers} buffers of {A} samples "
            f"({buffer_ms:.2f} ms of audio each), median / p90 / max ms per "
            f"buffer: as CUDA graphs {spread(times)} (real-time factor "
            f"{buffer_ms / (med * 1e3):.2f}x, {graph_calls:g} graph launches "
            f"a buffer), op by op {spread(eager_times)} "
            f"({buffer_ms / (eager_med * 1e3):.2f}x); init_state with its "
            f"capture {init_ms:.1f} ms; {KERNEL_NAME} and {SUM_NAME} "
            f"launches counted on the device {launches / n_buffers:g} and "
            f"{sums / n_buffers:g} a buffer")
        agree(f"streaming nb_steps {nb}: graph vs eager, {n_buffers} buffers",
              ys, eager_ys)
    # launches in the two streamed runs (2 x 64 buffers), counted on the
    # device; the *_per_buffer times are those of one buffer's 96 launches
    row["launches_streaming"] = launches_streaming
    row["launches_per_buffer"] = launches_streaming // (
        n_buffers * len(STREAM_STEPS))
    row["sum_splits_launches_per_buffer"] = sums_streaming // (
        n_buffers * len(STREAM_STEPS))
    row["graph_launches_per_buffer"] = {nb: 3 + nb for nb in STREAM_STEPS}
    row["buffer_ms_median"] = {nb: v[0] for nb, v in stream_rows.items()}
    row["buffer_eager_ms_median"] = {nb: v[1] for nb, v in
                                     stream_rows.items()}

    # a stream whose nb_steps (1-16) and guidances change every buffer
    attrs = [(1 + i % S, 1.0 + 0.8 * math.sin(i), 1.2 + math.cos(0.7 * i))
             for i in range(STREAM_CHANGING)]
    n = STREAM_CHANGING * A
    state = streamer.init_state(1)
    captures = streamer.graphs.captures
    reset_device_launches()
    times, ys = stream_audio(streamer, state, a[:, :n], b[:, :n], None,
                             attributes=attrs, x0s=x0s)
    changing = device_launches()[0]
    if streamer.graphs.captures != captures:
        fail("the stream was captured again after its first buffer")
    if changing != len(stream_path) * STREAM_CHANGING:
        fail(f"the device counted {changing} {KERNEL_NAME} launches in "
             f"{STREAM_CHANGING} buffers")
    eager_times, eager_ys = stream_audio(
        eager_streamer, eager_streamer.init_state(1), a[:, :n], b[:, :n],
        None, attributes=attrs, x0s=x0s)
    log(f"streaming: {STREAM_CHANGING} buffers with nb_steps 1-{S} and both "
        f"guidances changing every buffer: {streamer.graphs.captures - captures}"
        f" captures after init_state, {changing} {KERNEL_NAME} launches "
        f"counted on the device; median / p90 / max ms as CUDA graphs "
        f"{spread(times)}, op by op {spread(eager_times)}")
    agree(f"streaming with changing attributes: graph vs eager, "
          f"{STREAM_CHANGING} buffers", ys, eager_ys)

    nb = STREAM_STEPS[-1]
    state = streamer.init_state(1)
    one = dict(nb_steps=nb, guidance_timbre=GUIDANCE_TIMBRE)
    streamer.forward(state, a[:, :A], b[:, :A], **one)
    _, _, counts, ms = profile_call(
        f"one streamed buffer at nb_steps {nb} as CUDA graphs",
        lambda: streamer.forward(state, a[:, :A], b[:, :A], **one))
    replay_witness("one replayed buffer", counts, ms,
                   row["launches_per_buffer"],
                   row["sum_splits_launches_per_buffer"], row, "buffer")
    e_state = eager_streamer.init_state(1)
    eager_streamer.forward(e_state, a[:, :A], b[:, :A], **one)
    profile_call(f"one streamed buffer at nb_steps {nb} op by op",
                 lambda: eager_streamer.forward(e_state, a[:, :A], b[:, :A],
                                                **one))
    no_host_sync("one streamed buffer op by op",
                 lambda: eager_streamer.forward(e_state, a[:, :A], b[:, :A],
                                                **one))
    held = streamer.graphs.held_bytes()
    states = streamer.graphs.captures // (3 + S)
    log(f"streaming: the streamer's graph pool holds "
        + (f"{held / 2**20:.1f} MiB" if held is not None else "not measured")
        + f" after {states} states' captures ({3 + S} graphs a state; "
        f"capture time {streamer.graphs.capture_seconds / states * 1e3:.1f} "
        f"ms a state, with its warm-up in init_state)")

    phase_time("phase 6 (streaming)")

    # 7. streaming card vs CPU, for the base config and the causal one,
    # the card through its graphs
    if stream_card_vs_cpu(
            "base (crossfade)", streamer,
            Streamer(cfg, CHUNK, N_FADE, pipeline=cpu), STREAM_VS_CPU_BUFFERS,
            SEED + 2) != len(stream_path) * STREAM_VS_CPU_BUFFERS:
        fail("the base stream's replays did not launch the kernel on every "
             "ConvBlock1d")
    ccfg = get_config("base", "streaming")
    ccfg = ccfg.resolved(in_size=ccfg.autoencoder.z_channels,
                         n_signal=N_SAMPLES // ccfg.autoencoder.ratio)
    ccard = TransferPipeline(ccfg, device="cuda").init(SEED)
    ccpu = TransferPipeline(ccfg, device="cpu")
    ccpu.codec.load_state_dict(ccard.codec.state_dict())
    ccpu.rf.load_state_dict(ccard.rf.state_dict())
    if stream_card_vs_cpu(
            "base + streaming (causal, cached convs)",
            Streamer(ccfg, CHUNK, pipeline=ccard),
            Streamer(ccfg, CHUNK, pipeline=ccpu), STREAM_VS_CPU_BUFFERS,
            SEED + 3):
        fail("the causal codec launched the kernel on its cached convs")

    phase_time("phase 7 (streaming card vs CPU)")

    # 8. codec training at full width; 9. training card vs CPU
    del streamer, eager_streamer, state, e_state, ccard, ccpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    backward_rows = train_phase(row)
    grads = train_card_vs_cpu()
    row["grad_card_vs_cpu_training"] = {m: g[0] for m, g in grads.items()}

    phase_time("phases 8-9 (codec training)")

    # 10. diffusion training at full width; 11. its card vs CPU
    diffusion_phase(row, pipe.codec)
    row["grad_card_vs_cpu_diffusion"] = diffusion_card_vs_cpu()

    phase_time("phases 10-11 (diffusion training)")

    # 12. training from the command line
    cli_phase(row)

    phase_time("phase 12 (command line)")

    # 13. export and serving, from phase 12's runs; phase 15's packages of
    # its artifacts compile from each export on, beside phases 13 and 16
    started = start_packaging()
    devices = {"after.audio.diff": ("cuda",),
               "after.audio.diff.voices2": ("cuda", "cpu"),
               "codec_export": ("cuda",)}
    hosts = export_phase(row, a, b, attrs, on_export=lambda path: (
        package_in_background(started, path,
                              *devices[path.rstrip("/").split("/")[-1]])))

    phase_time("phase 13 (export and serving)")

    # 16. bf16 serving: the kernel's bf16 instantiation, the transfer, the
    # streamer and an artifact at compute_dtype bfloat16
    rows16 = bf16_phase(cfg, pipe, requests, ref_outs, short,
                        row["artifact_bytes"]["artifact"])

    phase_time("phase 16 (bf16 serving)")

    # 17. bf16 training: the codec (the bf16 backward kernels), card vs
    # CPU, the diffusion model, and both commands
    rows16 += bf16_train_phase(row)

    phase_time("phase 17 (bf16 training)")

    # 18. the alternative diffusion models: EDM, Denoiser v1, the UNet
    alternatives_phase(row, requests, short)

    phase_time("phase 18 (alternative diffusion models)")

    # 19. the codec's and the encoders' alternatives: the descript
    # discriminator, the decoder's NoiseGenerator, the VAE encoders
    codec_alternatives_phase(row, requests, short)

    phase_time("phase 19 (codec and encoder alternatives)")

    # 15. the native streaming host on phase 13's artifacts, their
    # packages done
    native_phase(row, a, b, attrs, started, hosts)
    del hosts

    phase_time("phase 15 (native host)")

    # 14. dataset preparation with phase 12's codec run, last: its host
    # transforms would share the CPU with phase 15's compiles
    dataset_phase(row)

    phase_time("phase 14 (dataset preparation)")

    # the card again, so that the end of a long output still names it
    log(f"card: {card_line()}")
    print(json.dumps({"kernels": [row, srow, *backward_rows, *rows16]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
