"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printed before the last line:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the CUDA kernel from its source in the checkout, with nvcc;
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
7. streaming card vs CPU: 8 buffers of two voices with fixed x0, the card
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
   a step (one codec forward); one more GAN generator step under
   torch.profiler as in phase 4 (no TF32 kernel but the port's own); peak
   device memory; the cost of weight norm and of the kernel's weight split
   per codec forward; then the kernel at every shape of a training codec
   forward (batch 8), as in phase 3, and its autograd Function's gradients
   for x, alpha, beta, w and b against plain autograd (each within
   GRAD_TOL x max |g| of its tensor), with the backward's time per
   generator step from CUDA graphs (and eager) beside ``F.conv1d``'s
   autograd backward at the same shapes from CUDA graphs;
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
   CPU (``move_to_device_pass``, the op's plain version there), 8 buffers
   of fixed noise within CARD_VS_CPU_TOL, the TF32 reading beside it; the
   codec artifact's ``forward`` against the live crossfade codec within
   GRAPH_TOL; then ``after-tpu-torch serve --artifact`` in its own
   process on 127.0.0.1 and a free port answers ``GET /api/info``, ``POST
   /api/timbre`` and ``POST /api/transfer`` with a 3 s WAV (200 each, a
   finite WAV of whole buffers back), each request timed, and is stopped.

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

Any failure exits non-zero.  The card's name and power limit are printed
again after phase 14.  The line before the last is the kernel table as
JSON (the snake+conv kernel and its split sum); the last line is ``{"ok":
true, "device": {...}}``.  Imports nothing of JAX or of after_tpu.
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
STREAM_VS_CPU_BUFFERS = 8
PEAK_TF32_FLOPS = 495e12     # H100 SXM, dense TF32 on the tensor cores
PEAK_F32_FLOPS = 67e12       # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
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
STREAM_CHANGING = 64         # buffers of the stream whose attributes change
TOP_KERNELS = 12
# the port's kernels that use TF32 on purpose (3xTF32, held to float64 in
# the kernel phase); any other kernel with "tf32" in its name fails the run
PORT_TF32_KERNELS = ("snake_conv_3xtf32",)
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
PROFILE_TRIES = 3            # profiles of an artifact buffer, for one that
                             # kept every kernel record


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


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


def vjp_ms(fwd, args, gy, reps: int = 5) -> float:
    """Device time of one backward of fwd(*args) against gy, in ms: the
    forward captured in one CUDA graph and reps backwards in a second on
    the same pool and stream, as torch.cuda.make_graphed_callables captures
    a backward; CUDA events around the backward graph's replay.  The inputs
    are fresh leaves: a leaf already used on the default stream carries that
    stream in its gradient node, and a captured backward would wait on it."""
    import torch
    args = [a.detach().clone().requires_grad_() for a in args]
    torch.cuda.synchronize()
    with torch.cuda.stream(torch.cuda.Stream()):
        for _ in range(2):
            torch.autograd.grad(fwd(*args), args, gy)
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    g_fwd, g_bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(g_fwd, pool=pool):
        y = fwd(*args)
    with torch.cuda.graph(g_bwd, pool=pool):
        for _ in range(reps):
            torch.autograd.grad(y, args, gy, retain_graph=True)
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
    """The autograd Function (kernel forward, plain version's VJP backward)
    against plain autograd at every distinct shape of ``path`` at
    ``batch``: each input's gradient within GRAD_TOL x its max |g|.
    Returns the worst ratio and the backward's time summed over one codec
    forward's launches, with its operations (recompute, dgrad, wgrad)."""
    import torch
    import torch.nn.functional as F
    from after_tpu_torch.ops.conv import get_padding, weight_norm
    from after_tpu_torch.ops.kernels.fused_conv import (fused_snake_conv,
                                                        snake_conv_reference)
    from after_tpu_torch.ops.snake import snake_beta

    counts = Counter(block_shape(b, T) for b, T in path)
    blocks = {block_shape(b, T): b for b, T in path}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst, bwd_ms, bwd_flops, lib_ms, eager_ms = 0.0, 0.0, 0.0, 0.0, 0.0
    log(f"gradients: SnakeConvFunction vs plain autograd at batch {batch} "
        "(k d C O T mode: n, worst |g - g_plain| / max|g_plain| over x "
        "alpha beta w b; backward ms from a CUDA graph / eager; F.conv1d's "
        "autograd backward ms from a CUDA graph)")
    for shape, block in sorted(blocks.items(), key=lambda kv: str(kv[0])):
        k, d, C, O, T, mode = shape
        with torch.no_grad():
            w = weight_norm(block.conv.weight, block.conv.g)
        args = [torch.randn((batch, T, C), generator=gen, device="cuda"),
                block.act.alpha.detach(), block.act.beta.detach(), w,
                block.conv.bias.detach()]
        gy = torch.randn((batch, T, O), generator=gen, device="cuda")
        ours = [a.clone().requires_grad_() for a in args]
        y = fused_snake_conv(*ours, d, mode)
        g_ours = torch.autograd.grad(y, ours, gy, retain_graph=True)
        plain = [a.clone().requires_grad_() for a in args]
        g_plain = torch.autograd.grad(snake_conv_reference(*plain, d, mode),
                                      plain, gy)
        ratio = max((a - p).abs().max().item() / p.abs().max().item()
                    for a, p in zip(g_ours, g_plain))
        if not ratio <= GRAD_TOL:
            fail(f"SnakeConvFunction {shape}: gradients differ from plain "
                 f"autograd by {ratio:.3e} x max|g| > {GRAD_TOL}")
        worst = max(worst, ratio)
        eager = cuda_ms(lambda: torch.autograd.grad(y, ours, gy,
                                                    retain_graph=True),
                        reps=5, warmup=1, graph=False)
        ms = vjp_ms(lambda *t: fused_snake_conv(*t, d, mode), ours, gy)
        left, right = get_padding(k, 1, d, mode)
        lib_args = [F.pad(snake_beta(*args[:3]).transpose(1, 2),
                          (left, right)).detach().requires_grad_(),
                    w.detach().clone().requires_grad_(),
                    args[4].detach().clone().requires_grad_()]
        lib = vjp_ms(lambda a, wl, bl: F.conv1d(a, wl, bl, dilation=d),
                     lib_args, gy.transpose(1, 2).contiguous())
        n = counts[shape]
        bwd_ms += n * ms
        eager_ms += n * eager
        lib_ms += n * lib
        bwd_flops += n * 3 * 2.0 * k * C * O * T * batch
        log(f"  {k} {d} {C} {O} {T} {mode}: {n}, {ratio:.3e}; {ms:.4f} / "
            f"{eager:.4f}; {lib:.4f}")
    bound_ms = 1e3 * bwd_flops / PEAK_F32_FLOPS
    log(f"gradients: worst {worst:.3e} x max|g| (limit {GRAD_TOL}); backward "
        f"per generator step ({len(path)} launches' VJPs) {bwd_ms:.3f} ms "
        f"from CUDA graphs ({eager_ms:.3f} ms eager), F.conv1d's autograd "
        f"backward {lib_ms:.3f} ms from CUDA graphs; {bwd_flops / 1e9:.1f} "
        f"GFLOP (recompute + dgrad + wgrad in strict f32; bound on the f32 "
        f"CUDA cores {bound_ms:.3f} ms)")
    return worst, bwd_ms, bound_ms, lib_ms, eager_ms


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
    from after_tpu_torch.ops.kernels.fused_conv import fused_snake_conv

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
        values = {k: float(v) for k, v in metrics.items()}
        codec, disc = flat_params(tr.codec), flat_params(tr.disc)
        moved = (not torch.equal(codec, snap["codec"]),
                 not torch.equal(disc, snap["disc"]))
        records.append((kind, dt, launches, values, moved))
        log(f"training: step {tr.step - 1} ({kind}): {dt * 1e3:.2f} ms, "
            f"fused_snake_conv launches +{launches}, " + ", ".join(
                f"{k} {v:.5g}" for k, v in values.items()))
        snap.update(codec=codec, disc=disc,
                    launches=fused_snake_conv.launches)
        torch.cuda.synchronize()
        snap["t0"] = time.perf_counter()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused_snake_conv.launches = 0
    snap["launches"] = 0
    torch.cuda.synchronize()
    snap["t0"] = time.perf_counter()
    trainer.fit(iter(batches[:TRAIN_STEPS]), max_steps=TRAIN_STEPS,
                callback=callback)
    launches = fused_snake_conv.launches
    peak = torch.cuda.max_memory_allocated()
    if launches == 0 or len(records) != TRAIN_STEPS:
        fail(f"fit ran {len(records)} steps with {launches} kernel launches")
    for i, (kind, _, n, values, (codec_moved, disc_moved)) in enumerate(
            records):
        if n != per_forward:
            fail(f"training step {i}: {n} kernel launches, expected "
                 f"{per_forward} (one codec forward)")
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
    grad_worst, bwd_ms, bwd_bound, bwd_lib_ms, bwd_eager_ms = check_gradients(
        enc + dec, tc.batch_size)
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
        "backward_ms_per_gen_step": bwd_ms,
        "backward_eager_ms_per_gen_step": bwd_eager_ms,
        "backward_library_ms_per_gen_step": bwd_lib_ms,
        "backward_bound_f32_ms_per_gen_step": bwd_bound,
        "grad_err_training": grad_worst,
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


def profile_kept(label: str, fn, expected):
    """Up to PROFILE_TRIES profiles of fn (profile_call), the device's
    launch counts set to 0 before each; fails unless the device counts
    ``expected`` (launches of the kernel, of its split sum) in each.
    Returns (busy ms, the kernel's device ms, the split sum's device ms) of
    the first profile that recorded every launch the device counted, else
    (None, None, None): the profiler may lose a kernel record late in a
    long process, and a profile that did lacks part of the kernel's time."""
    from after_tpu_torch.ops.kernels.fused_conv import (device_launches,
                                                        reset_device_launches)

    for attempt in range(1, PROFILE_TRIES + 1):
        reset_device_launches(DEVICE)
        _, busy, counts, ms = profile_call(f"{label}, profile {attempt}", fn)
        device = device_launches(DEVICE)
        if device != tuple(expected):
            fail(f"{label} launched {device}, expected {tuple(expected)}")
        recorded = tuple(kernel_launches(counts, k)
                         for k in (KERNEL_NAME, SUM_NAME))
        log(f"profile: {label}, profile {attempt}: the device counted "
            f"{device[0]} {KERNEL_NAME} and {device[1]} {SUM_NAME} launches, "
            f"the profiler recorded {recorded[0]} and {recorded[1]}")
        if recorded == device:
            kernel_ms = kernel_launches(ms, KERNEL_NAME)
            sum_ms = kernel_launches(ms, SUM_NAME)
            log(f"profile: {label}: {KERNEL_NAME} {kernel_ms:.3f} ms and "
                f"{SUM_NAME} {sum_ms:.3f} ms on the device, busy "
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
    ``ConvBlock1d`` output (a launch of the kernel) to its plain version
    on the same input: fails past KERNEL_TOL x max|y|, keeps the worst
    ratio in ``worst[0]`` and counts the checks in ``checked[0]``."""
    import torch
    from after_tpu_torch.models.autoencoder import ConvBlock1d
    from after_tpu_torch.ops.kernels.fused_conv import snake_conv_reference

    @torch.no_grad()
    def check(mod, args, y):
        if not isinstance(mod, ConvBlock1d):
            return
        h = mod.gn(args[0]) if mod.gn is not None else args[0]
        ref = snake_conv_reference(h.contiguous(), mod.act.alpha,
                                   mod.act.beta, mod.conv.effective_weight(),
                                   mod.conv.bias, mod.conv.dilation,
                                   mod.conv.mode)
        err = (y - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= KERNEL_TOL * scale:
            fail(f"{label}: fused_snake_conv at {tuple(h.shape)} off its "
                 f"plain version by {err} > {KERNEL_TOL} * {scale}")
        worst[0] = max(worst[0], err / scale)
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
    from after_tpu_torch.ops.kernels.fused_conv import (device_launches,
                                                        fused_snake_conv,
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
        f"{ae_launches[1]}); the restart's {ae_checked[0]} (device "
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


def serve_phase(art: str, sr: int, audio_chunk: int) -> dict:
    """``after-tpu-torch serve --artifact`` in its own process on
    127.0.0.1 and a free port: /api/info, then /api/timbre and
    /api/transfer with a SERVE_SECONDS WAV; each must answer 200, the
    transfer a finite WAV of whole buffers.  The server is stopped in any
    case.  Returns each request's ms."""
    import io
    import select

    import numpy as np
    import scipy.io.wavfile

    t = np.arange(int(SERVE_SECONDS * sr)) / sr
    rng = np.random.RandomState(SEED + 13)
    wav = _wav_bytes(0.4 * np.sin(2 * np.pi * 220.0 * t)
                     + 0.05 * rng.randn(len(t)), sr)
    proc = subprocess.Popen(
        [sys.executable, "-m", "after_tpu_torch.cli.main", "serve",
         "--artifact", art, "--host", "127.0.0.1", "--port", "0",
         "--device", DEVICE],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out, ms = [], {}
    try:
        t0 = time.perf_counter()
        base = None
        while base is None:
            left = SERVE_START_TIMEOUT - (time.perf_counter() - t0)
            if left <= 0 or not select.select([proc.stdout], [], [],
                                              left)[0]:
                fail(f"serve: no address within {SERVE_START_TIMEOUT} s: "
                     + "".join(out)[-2000:])
            line = proc.stdout.readline()
            if not line:
                fail(f"serve exited with {proc.wait()}: "
                     + "".join(out)[-2000:])
            out.append(line)
            if "frontend at http://" in line:
                base = line.strip().split(" at ")[1]
        ms["start"] = (time.perf_counter() - t0) * 1e3
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
        got_sr, y = scipy.io.wavfile.read(io.BytesIO(body))
        want = -(-len(t) // audio_chunk) * audio_chunk
        if (status != 200 or ctype != "audio/wav" or got_sr != sr
                or len(y) != want or not np.isfinite(y).all()):
            fail(f"serve: /api/transfer answered {status} {ctype}, "
                 f"{len(y)} samples at {got_sr} Hz (expected {want})")
        log(f"serve: after-tpu-torch serve --artifact on {base}: address "
            f"after {ms['start']:.0f} ms (its process starting, the "
            f"artifact loading and capturing), GET /api/info "
            f"{ms['info']:.1f} ms, POST /api/timbre of {SERVE_SECONDS:g} s "
            f"{ms['timbre']:.1f} ms, POST /api/transfer of {SERVE_SECONDS:g}"
            f" s at nb_steps {EXPORT_STEPS} {ms['transfer']:.1f} ms "
            f"({len(y)} samples, {len(y) // audio_chunk} buffers, finite, "
            f"rms {float(np.sqrt(np.mean((y / 32767.0) ** 2))):.4f}); each "
            f"answered 200")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return ms


def export_phase(row, a, b, attrs) -> None:
    """Phase 13: export and serving (see the module docstring), from the
    runs phase 12 left; ``a`` and ``b`` are phase 6's request and
    ``attrs`` its changing attributes."""
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
    for label, argv in (
            ("export", export),
            ("export --batch_size 2", export + ["--batch_size", "2",
                                                "--out", art2]),
            ("export_autoencoder", ["export_autoencoder", "--model_path",
                                    ae_run, "--chunk_size", str(CHUNK),
                                    "--device", DEVICE])):
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        if rc != 0:
            fail(f"{label} exited with {rc}")
    sizes = {}
    for label, path in (("artifact", art), ("codec artifact", codec_art)):
        files = _dir_bytes(path)
        sizes[label] = sum(files.values())
        bins = [v for k, v in files.items() if k.endswith(".bin")]
        log(f"export: {label} {path}, {sizes[label] / 2**20:.1f} MiB: "
            + ", ".join(f"{k} {v}" for k, v in files.items()
                        if not k.endswith(".bin"))
            + f", state/leaf_<i>.bin {len(bins)} files {sum(bins)} bytes")
    log("export: seconds (on the card, in this process): " + ", ".join(
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

    # the kernel against its plain version on this path: the two-voice
    # artifact on the card and moved to the CPU, where the op is the plain
    # version
    del host
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
    del card
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    err_tf32 = (voices(ExportedStreamer(art2, DEVICE)) - y_cpu
                ).abs().max().item()
    strict_f32()
    log(f"artifact card vs CPU: {STREAM_VS_CPU_BUFFERS} buffers of 2 voices "
        f"(the artifact of --batch_size 2, moved to the CPU with "
        f"move_to_device_pass), max abs err {err:.3e} (with TF32 allowed: "
        f"{err_tf32:.3e}), max |y| {scale:.4f}, tolerance {CARD_VS_CPU_TOL} "
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
    del codec, streamer, pipe
    gc.collect()
    torch.cuda.empty_cache()

    serve_ms = serve_phase(art, cfg.sr, A)
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")

    import numpy as np
    from after_tpu_torch import TransferPipeline, get_config
    from after_tpu_torch.models.autoencoder import ConvBlock1d
    from after_tpu_torch.streaming import Streamer
    from after_tpu_torch.ops.kernels.build import load
    from after_tpu_torch.ops.kernels.fused_conv import (SOURCE,
                                                        device_launches,
                                                        fused_snake_conv,
                                                        reset_device_launches)
    from after_tpu_torch.utils.device import strict_f32

    # 1. card
    log(f"card: {card_line()}")
    log(f"card: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    load(SOURCE)
    log(f"build: {SOURCE} in {time.perf_counter() - t0:.2f} s")

    cfg = get_config("base")
    cfg = cfg.resolved(in_size=cfg.autoencoder.z_channels,
                       n_signal=N_SAMPLES // cfg.autoencoder.ratio)
    t0 = time.perf_counter()
    pipe = TransferPipeline(cfg, device="cuda").init(SEED)
    torch.cuda.synchronize()
    log(f"serving: base config, port-native init (seed {SEED}) in "
        f"{time.perf_counter() - t0:.2f} s")

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

    # 8. codec training at full width; 9. training card vs CPU
    del streamer, eager_streamer, state, e_state, ccard, ccpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    train_phase(row)
    grads = train_card_vs_cpu()
    row["grad_card_vs_cpu_training"] = {m: g[0] for m, g in grads.items()}

    # 10. diffusion training at full width; 11. its card vs CPU
    diffusion_phase(row, pipe.codec)
    row["grad_card_vs_cpu_diffusion"] = diffusion_card_vs_cpu()

    # 12. training from the command line
    cli_phase(row)

    # 13. export and serving, from phase 12's runs
    export_phase(row, a, b, attrs)

    # 14. dataset preparation with phase 12's codec run
    dataset_phase(row)

    # the card again, so that the end of a long output still names it
    log(f"card: {card_line()}")
    print(json.dumps({"kernels": [row, srow]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
