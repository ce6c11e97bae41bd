#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (promonet_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printed as one JSON line with the seconds since the start
(`elapsed_s`); any failure exits non-zero:

1. device: the card's name and power limit.
2. build: the four CUDA kernels from `promonet_tpu_torch/csrc`, one
   `nvcc` each, in parallel.
3. check: each kernel against its plain PyTorch version on the card.
   The residual block (K1) at every (C, k) of the main path, at the
   main path's shapes (batch 1), at ragged lengths (batch 4), at the
   batched path's (batch 8 on the 896-frame bucket) and at the streaming
   window's (batch 1, 64 frames), bounded per element by
   |kernel - plain| <= 2^-5 * (|plain| + 2 * rms(plain)), and at every
   batch above one the bound must fail once a single bias is zeroed; the
   same at an
   odd width (C = 48, k = 7, batch 2), which the wrapper zero-pads, and
   at lengths shorter than one thread block of the fused pair, ending
   inside its recomputed halo, and shorter than the halo. The
   Viterbi decode (K2) on random, tie-heavy, -inf-masked and NaN-frame
   (896, 256) observations, on one, two and 4096 frames, under an
   all-equal and a random dense transition (no band) and on a batch of
   three, paths equal exactly to the plain scan's on the card and on the
   CPU. The log-frequency Viterbi decode (K3) on random, tie-heavy,
   -inf-masked, NaN-frame and empty-band (861, 2039) observations over
   the harmonics path's frequency axis, on a batch of two against two
   single decodes, on (70, 200) (a cluster of one block), on one and two
   frames, on the same axis through the grid route, and on a 3000-state
   axis that takes the grid route by the rule, paths equal exactly; the
   harmonics axis must take the cluster route.
4. main path, full width (HiFi-GAN 512, 109 speakers), weights seeded
   from numpy: preprocess.from_audio(loudness_bands=None) →
   edit.from_features(+400 cents, stretch 1/1.4, +3 dB) →
   synthesize.from_features(speaker=3) on 10 s of harmonic audio. The
   launch counters must show 12 residual-block calls and 1 Viterbi
   decode per utterance; the audio must be finite and frames * HOPSIZE
   long. The second call is timed.
5. reference: a half-second input on the card and through the plain
   CPU path in float32 with the same weights: loudness within 0.05 dB,
   PPG within 1e-3, and the generator's audio from the same features
   within 5% relative RMS (bf16 on the card against float32).
6. second path, full width, the same 10 s: preprocess.from_audio with
   'harmonics' (the counters must show two log-frequency launches for
   the MAX_HARMONICS decodes: F0, then the other harmonics as one batch;
   the contours must be (3, frames), finite and within three
   bins of the signal's harmonics in the median, equal to the contours
   that the plain scan over the dense transition decodes on the card
   from the same 10 s of STFT frames, and on a half-second input equal
   to the plain CPU path's on the same STFT frames), then
   synthesize.from_edited_audio with the defaults and with
   PITCH_ESTIMATOR='dsp' and stretch_unvoiced=False (12 residual-block
   calls and 1 Viterbi decode each, finite audio of
   round(frames * 1.4) * HOPSIZE samples). Second calls are timed.
7. batched path: eight utterances of one bucket (the 10 s audio extended
   to its 896-frame bucket, at eight pitch shifts and speakers) through
   synthesize.from_features_batched, one generator call with K1 at batch
   8 (12 residual-block calls); each row within the bf16 bound of its own
   single from_features call.
8. stream path: synthesize.Streamer (16 | 32 | 16 frames) fed the main
   path's 861 frames in 10-frame pieces, then flushed: 12 residual-block
   calls per window, frames * HOPSIZE finite samples, interior
   correlation with offline synthesis above 0.9.
9. FARGAN path (configs/fargan.py, bf16, seeded): synthesize.from_features
   offline, then synthesize.FARGANStreamer in 32-frame chunks; no K1-K3
   launches, one K4 launch a subframe (`k4_launches`, two calls each); the
   chunked audio held to the offline audio by the bounds
   FARGAN_FIRST_FRAMES_BOUND (first four frames), FARGAN_MAX_ABS_BOUND
   and FARGAN_CORRELATION_BOUND. Then K4 against the plain subframe
   (phase `fargan_kernel`): one more offline synthesis with a forward
   hook on the subframe, every call's output and states held to
   `SubframeNetwork.plain` in float32 from the same inputs (relative
   gaps within FARGAN_K4_OUTPUT_GAP and FARGAN_K4_STATE_GAP), the fed
   pitch lookback and previous subframe equal to the loop's own
   samples; K4's device time a launch (profiler), the plain bf16
   subframe's time a call and K4's bound.
10. Vocos path (configs/baselines/vocos.py, bf16, seeded): finite audio
   of frames * HOPSIZE samples, no kernel launches.
11. file path: the 10 s audio as a wav file → preprocess.from_file_to_file
   → harmonics.from_file_to_file (with the saved pitch) →
   edit.from_file_to_file → synthesize.from_file_to_file, in a temporary
   directory under build/: the cache's file names, an output of
   round(frames * 1.4) * HOPSIZE samples, 12 residual-block calls, 1
   Viterbi decode and 1 log-frequency launch; edit.from_file's features
   must lie on the card and equal the files the chain wrote.
   Paths 7 to 11 are each timed on their second call, with every launch
   count set to 0 just before it and read just after; one call of the
   batched path, one streaming window, one FARGAN chunk and one Vocos
   call are then run under torch.profiler for their device events and
   busy time.
12. zero-shot path (configs/promonet-zeroshot.py, HiFi-GAN 512, bf16,
   seeded generator and speaker encoder): preprocess.speaker.from_audio of
   the 10 s audio on the card (finite, unit norm, on the card, within
   1e-4 of the plain CPU path's), then synthesize.from_features with that
   x-vector on the main path's edit (12 residual-block calls),
   from_features_batched with eight x-vectors on the batched path's sets
   (12 calls at batch 8, each row within the bf16 bound of its single
   call) and a Streamer fed 10 frames at a time (12 calls per window,
   interior correlation with offline synthesis above 0.9); each timed on
   its second call and profiled once for the card's idle share.
13. CLI path: the main path's seeded weights written as port checkpoints
   under build/, then `python -m promonet_tpu_torch.preprocess` (all but
   the speaker feature: 1 Viterbi decode, 2 log-frequency launches),
   `...edit` (the main path's edit) and `...synthesize` (12 residual-block
   calls) each in a process of its own with `--gpu 0`, each with its own
   timeout; what they write against the same `from_files_to_files` calls
   in this process: the same names, decoded pitch, periodicity and
   harmonics equal, the other features within 1e-5 of their scale, the
   audio within the bf16 bound. Each CLI's wall time includes its
   process start and the kernel load from build/kernels/.
14. evaluation path, full width (HiFi-GAN 512, bf16, the seeded weights
   of phase 4 written as port checkpoints under build/, the PPG one
   making a transcriber available): data.synthetic.create (4 speakers x
   3 utterances x 2 s, the default configuration) on the card, one
   Viterbi decode per wav and a spectrogram file per stem; then
   evaluate.datasets over its 4 test stems x 11 conditions (44 jobs),
   with each phase's launches and HiFi-GAN calls counted: 44 Viterbi
   decodes in the re-preprocess and 12 residual-block calls per
   generator call; results.json with all 11 conditions and finite
   loudness, periodicity and PPG, every job's wav and .npy files, each
   phase's seconds and RTF, and the card's idle share over one profiled
   re-preprocess. The card's metrics are recomputed on the CPU from the
   exported files (within 1e-6 relative) and one job's edit on the card
   is held to the CPU's with phase 5's tolerances. One job's audio,
   zero-padded to the run's top bucket, is preprocessed again on the
   card and through the plain CPU path in float32 (loudness within 0.05
   dB, PPG within 1e-3, pitch and periodicity reported as phase 5 does),
   and K2 decodes the card's and the CPU's pitch observations of it and
   a random one at that length, paths equal exactly to the plain scan's
   on the card and on the CPU. Then the mels baseline
   (configs/baselines/mels.py, seeded MelGenerator) over the same
   corpus: only 'reconstructed' runs, one generator call (12
   residual-block calls) per stem, and its audio within 5% relative RMS
   of the plain CPU path in float32. K1 is then held to the bf16 bound,
   with the zeroed-bias control above batch one, at every (batch,
   frames) that the two evaluations' HiFi-GAN calls were given (the
   bucket groups at batch 8, the mels stems at batch 1). Last `python -m
   promonet_tpu_torch.evaluate --gpu 0 --max_stems 1` in a process of
   its own must write results.json with the same conditions. Then the
   WORLD baseline (configs/baselines/world.py) over the same corpus:
   all 11 conditions with finite loudness, periodicity and PPG, the 44
   jobs' audio made on the host and preprocessed again on the card (44
   Viterbi decodes, no residual-block call), and one job's audio equal
   to `baseline.world.from_audio` called on its input.
15. training path, full width (the default configuration: HiFi-GAN 512,
   five period and the complex multi-band discriminators, batch 64 of
   16384 samples, bf16, REMAT; the seeded extractors of phase 4 written
   as port checkpoints under build/): a formant corpus of 16 speakers x 6
   utterances x 1 s made on the host, augmented (`data.augment`) and
   preprocessed on the card (one K2 decode per wav, 288), its partition
   holding 64 training stems (192 items with their copies) and 16
   validation ones; `train` for 3 steps, with its validation at step 0,
   then a second call that resumes from the step-3 checkpoint to step 5.
   Each step is timed by CUDA events (the median of steps 1, 2 and 4
   reported: the first step of a call builds cuDNN's plans), its losses
   must be finite and its launches show no residual-block call; the
   validation must show 16 generator calls of 12 residual-block calls
   each and 16 pitch decodes. Peak memory of each call, one more step
   under torch.profiler (idle share and the kernels that take the most
   time), an edit of the main path's features served from the step-5
   checkpoint (12 residual-block calls), K1 held to its bound at the
   validation's (batch, frames) and at batch 2 with the zeroed-bias
   control, K2 on the card's and the CPU's pitch observations of one
   validation item's audio and a random one (paths equal), one narrow
   float32 step on the card against the same step on the CPU (losses
   within 1e-4 relative), and one speaker's adaptation (12 utterances,
   2 held out, batch 16, ADAPTATION_STEPS 2 from the step-5 checkpoint)
   through evaluate.datasets(adapt=True), whose generator calls launch
   12 residual-block calls each. Phases 15 and 16 and the adaptation set
   RESIDENT_DATA = False: their steps read the host loader, so that
   their times stay comparable with the host-loader runs recorded before
   resident data became the default on the card.
15a. resident training, full width as phase 15, on its corpus, with
   RESIDENT_DATA = None, which resolves to the device-resident corpus on
   the card: the training partition packed on the host and copied to the
   card once (its bytes on the card, pack and upload seconds); `crops` on
   the card equal to `crops` on the CPU for the same rows and starts, and
   4096 drawn starts within their stems; `train` for 4 steps
   (STEPS_PER_DISPATCH auto: one dispatch of 4) with validation at step
   0, resumed to step 6 with STEPS_PER_DISPATCH = 2; each step timed by
   CUDA events (median without each call's first step) beside phase 15's
   host-loader median, peak memory, the callbacks at steps 3 and 5 only,
   the host loader asked for the validation partition alone, no
   residual-block call in a step, the validation's 16 generator calls of
   12 residual-block calls and 16 pitch decodes; one profiled dispatch
   of two steps (idle share, device events per step); K1 held to its
   bound at the validation's (batch, frames) and at batch 2 with the
   zeroed-bias control.
15b. pause and notify: a resident run of 8 steps in dispatches of 2 on a
   thread; after its second dispatch this thread takes
   `utils.pause.exclusive()`: the trainer acknowledges (request to
   acknowledgement in seconds), has written generator-00000004.pt in its
   `on_pause`, and takes no step across a 2 s hold (its step count and a
   checksum of the generator's trainable weights unchanged); released,
   the run finishes at step 8, leaves no protocol file, and
   notifications.jsonl holds its 'train' start and completion; phase 14's
   RUNS_DIR held the start and completion of its corpus's preprocessing
   and of each of its four evaluate.datasets calls.
15c. data parallel: a process group of one rank under NCCL (a FileStore
   under build/), `train` at full width for 2 steps in one resident
   dispatch (5 all-reduces: two gradient buckets a step and the metrics;
   finite metrics), then from one seeded state and resident batch two
   steps without the group (their spread is the card's run-to-run bound)
   and one as rank 0 of the group, whose losses lie within that spread or
   1e-3 relative. The group is destroyed before the later phases. Two
   ranks are held equal to one process and to the JAX package's
   2-device step by `tests/test_torch_parallel.py` on the CPU (gloo).
16. FARGAN training path, full width (configs/fargan.py: batch 256 x
   4096 samples, bf16, the five period and the complex multi-band
   discriminators from step 0, spectral-convergence loss): a formant
   corpus of 16 speakers x 8 utterances x 1 s (288 training items with
   their augmented copies, 16 validation items) made on the card; `train`
   for 3 steps with its validation at step 0, then resumed to step 5.
   Each step timed by CUDA events, its losses finite, no residual-block
   call; the validation 16 FARGAN calls, 16 pitch decodes and no
   residual-block call; peak memory of each call and one profiled step's
   idle share; one narrow float32 step on the card against the same step
   on the CPU, both drawing the same training noise (losses within 1e-4
   relative).
17. export path: `python -m promonet_tpu_torch.models.export` on the main
   path's seeded generator in a process of its own (a `.pt2` program and
   a `.pt` of parameters), then in a second process `torch.export.load`
   and a run on the main path's features packed at 32 frames: 12
   residual-block calls, audio of 8192 samples within the bf16 bound of
   eager `packed_inference`; the program's and eager times; K1 against
   its plain version at that program's Block shapes; then `python -m
   promonet_tpu_torch.data.pack` on the main path's features saved under
   the cache's names: a `.npy` equal to `data.pack.from_features` and a
   `.csv` with the time column and `labels()` as its header.
18. CARGAN path: `models.cargan.CARGAN` (the HiFi-GAN 512 and its
   autoregressive encoder, seeded) once in bf16 on the main path's
   features: 12 residual-block calls, finite audio of frames * HOPSIZE
   samples; half a second of those features through the plain CPU path
   in float32 with the same weights within 5% relative RMS.
19. extractor training: `preprocess.pitch.train` (batch 128, tone
   fraction 0.4), `preprocess.ppg.train` and `preprocess.speaker.train`
   (batch 32, window 256) on the card at the JAX package's widths and
   learning rates over phase 15's corpus, 1500, 1200 and 1200 steps (cut
   from 4000, 3000 and 4000), each step timed by CUDA events (median and
   spread, steps/s, the time the default steps would take), peak memory,
   the first and last loss (the last must be below the first, all
   finite), the held-out figures, and no kernel launch.
20. extractor card against CPU: for each extractor one float32 step on
   the card and on the CPU from the same seeded weights on the same batch
   of its training examples (the JAX package's batch size): the loss
   within 1e-4 relative, 99% of the updated weights within 1e-4 of their
   leaf's largest magnitude and every one within 2 lr more.
21. trained extractors: the three checkpoints of phase 19 read by
   `load.pitch_model`, `load.ppg_model` and `load.speaker_encoder`, then
   `preprocess.from_audio` with the speaker feature on the main path's
   audio: one K2 decode, its pitch equal to K2's decode of the trained
   CNN's posteriorgram, whose path equals the plain scan's on the card and
   on the CPU; finite outputs, a unit x-vector, and the pitch error in
   cents against the signal's known pitch (reported).
22. from_probabilities: `ops.viterbi.from_probabilities` on (896, 256)
   probabilities under its default uniform transition (every predecessor
   ties) and under the pitch decode's: one K2 launch each, paths equal
   to the plain scan's on the card and on the CPU; then 1, 300 and 384
   samples (the reflect padding's repair) through the spectrogram, the
   log-mels, the loudness (from 256 samples) and the trained speaker
   encoder on the card: finite, on the card, of the JAX package's shapes.
22a. plot: the trained speaker encoder's embeddings (on the card) of
   phase 15's 96 utterances, laid out by `plot.umap.UMAP` on the host:
   its seconds and the ratio of the mean distance to the own speaker's
   centroid to the mean distance between centroids; where matplotlib
   imports, the prosody figure of one validation item and the speaker
   figure saved under build/figures/ (a drawing error fails the phase),
   else the line says "matplotlib not installed".
22b. shipped weights: the checkpoints the repository ships (the pitch
   CNN, PPG encoder and speaker encoder under
   promonet_tpu/assets/checkpoints, the release generator
   runs/promonet/release/generator-00155000), orbax directories read on
   this host by the port's own reader (`utils.checkpoint`, `utils.ocdbt`
   and the zstd decoder `csrc/zstd.cpp`, built with g++): each one's
   seconds, MB and the decoder's MB/s, its tree held to the SHA-256
   digest in SHIPPED_DIGESTS. Then, with no checkpoint of the port's own
   (an empty CHECKPOINTS_DIR), the default models `load` resolves (the
   shipped ones): `preprocess.from_audio` on the main path's audio, one
   K2 decode, pitch within PITCH_THRESHOLD_CENTS of the signal's known
   pitch in the median, the shipped speaker encoder's unit x-vector and a
   transcriber; then the release generator read by name and from its run
   directory runs/promonet/release (resolved to generator-00155000 as
   the JAX package resolves it; the two state dicts' digests equal), and
   the main path's edit with the latter under runs/promonet/synthetic.py
   (24 speakers), twice: 12 K1 and 1 K2
   launches a call, finite audio of frames * HOPSIZE samples, the second
   call timed, and the output's pitch (read by the same extractors)
   against the edited contour, reported. Where the release generator is
   not in the checkout, its line says "release_generator": "absent" and
   the extractors' part still runs and gates.
22c. dataset pipeline: `run.sh`'s dataset chain through the port's
   command lines, each in a process of its own with `--config` (every
   directory under a temporary directory in build/, an empty
   CHECKPOINTS_DIR, so the extractors are the shipped ones, STEPS 2,
   TRAINING_DATASET 'libritts'; else the default configuration at full
   width) and `--gpu 0`, on trees made
   from a seed in the published datasets' layouts (PIPELINE_TREES): a
   LibriTTS tree at 24 kHz (the ten held-out speakers of the recomputed
   partition and 14 others, 12 utterances each: 288 wavs, 12.6 minutes),
   a DAPS tree at 44.1 kHz (20 speakers, one quiet) and a VCTK tree at 48
   kHz (4 speakers x 3 utterances x 2 microphones, one utterance without
   a transcript). `data.download` (DAPS, LibriTTS, VCTK): the cache
   layout, speakers.json in order of first appearance, the quiet
   speaker's takes at a 0.35 peak, 22 of VCTK's 24 takes kept with
   correspondence.json and every `-100.wav` at SAMPLE_RATE;
   `data.augment`, `data.preprocess` (one K2 decode per cached wav),
   `partition` (20 test stems, all of the held-out speakers, at least a
   batch to train on, no stem in two splits), `train` (a generator
   checkpoint at step 2, finite validation losses, 12 K1 and 1 K2 per
   validation item; the variable pitch bins its generator computed,
   cached under stats/ beside the cache, equal to the quantiles
   recomputed here from the train partition's cached pitch, strictly
   increasing and not the log-uniform fallback) and `evaluate`
   (results.json with the 11 conditions and finite loudness, periodicity
   and PPG; the bins' file left as it was) over LibriTTS; the run
   directory's notifications.jsonl holds the start and completion of
   download, augment, preprocess, train and evaluate, in order. Each step's
   line: its wall seconds (the process start included), the wavs and
   seconds of audio it handled, its process's launch counts and the
   card's name and power limit. In this process: the preprocess CLI's
   files of three wavs against `preprocess.from_file` with the same
   shipped extractors (pitch and periodicity equal, the other features
   within 1e-5 of their scale, 1 K2 a call), and one test stem edited
   with the trained checkpoint (12 K1, 1 K2, finite audio of the edited
   length).
23. time and kernels: K1 per (T, C, k) with its time, TFLOP/s, CUDA
   launches per Block, the time at each number of row tiles per thread
   block, the plain chain's and cuDNN's times and the bound; K2 with the
   forward pass and the backtrace timed apart, microseconds per frame
   and the time at 4096 frames; K3 with its route and cluster size, the
   forward pass and the backtrace apart, microseconds per frame at 2039
   and at 200 states, a batch of two, the grid route on the same input,
   the reading behind the split's cost per destination and the cycles of
   each section of a frame. Then per
   kernel its
   launches (the main path's; K2's other call sites, phases 21, 22, 22b
   and 22c, and K1's in phases 22b and 22c, apart under
   `launches_by_call_site`; K4's, which the main path does not run, those
   of phase 9's checked synthesis, its other FARGAN calls apart), error (for the two decodes the
   largest difference in state index seen in this run's checks), time,
   plain and library times and
   the card's bound, the seconds of each phase, then the card's name and
   power limit, then {"ok": true, "device": ...} as the last line.

TF32 is off for every comparison (cuDNN and cuBLAS), so float32 work
runs in float32, except in phase 13, where both sides run with PyTorch's
defaults, as the CLI processes do.
"""
import hashlib
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM peaks (data sheet, dense): bf16 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

DILATIONS = (1, 3, 5)
KERNEL_SIZES = (3, 7, 11)

# Frames the batched path's utterances are padded to (10 s of audio is
# 861 frames) and frames of one window of synthesize.Streamer's default
# 16 | 32 | 16
BATCHED_BUCKET = 896
STREAM_WINDOW = 64
BF16_RTOL = 2. ** -5

# Chunked FARGAN against one offline pass, in bf16: the conditioning
# network's products run over other row counts, and a rounding that
# differs is fed back through the recurrence. Bounds: the first four
# frames within one bf16 step at the output's scale (2^-10 for samples in
# [0.125, 0.25); the seeded output peaks near 0.18), the whole 10 s
# within four, correlation as the JAX package's float32 contract. On an
# H100 the first four frames were equal, the whole within one step and
# the correlation 0.9999957.
FARGAN_FIRST_FRAMES_BOUND = 2. ** -10
FARGAN_MAX_ABS_BOUND = 2. ** -8
FARGAN_CORRELATION_BOUND = 0.9999

# K4 against the plain subframe in float32 from the same inputs: the
# benchmark's readings of the plain bf16 program against its float32
# reference over 25 seeds (PERF.md, section 2), as the card tests hold
# it: every subframe's output and the worst carried state, relative
FARGAN_K4_OUTPUT_GAP = 0.006
FARGAN_K4_STATE_GAP = 0.0047
# Bytes one K4 launch moves a row besides the weights: the conditioning
# slice, lookback, previous subframe and four states read (bf16), the
# output and states written (bf16) and the samples (float32), and the
# next subframe's lookback indices (int64) and samples (float32) read and
# its lookback and previous subframe written (bf16)
K4_ROW_BYTES = 6096

# The checkpoints the repository ships, as orbax directories, and the
# SHA-256 (`tree_digest`) of the tree the JAX package's
# `utils.checkpoint.load` restores from each; tests/test_torch_orbax.py
# recomputes these from orbax on the CPU
SHIPPED_DIGESTS = {
    'promonet_tpu/assets/checkpoints/pitch':
        'e4151669631582f9439e89e74a0c890440e2eca2e7e7879e66edb2b469fe261a',
    'promonet_tpu/assets/checkpoints/ppg':
        '9196e6bbae0bee687251c9ba69611f03d327604cd3991a9eddf814991ae0dd37',
    'promonet_tpu/assets/checkpoints/speaker':
        'b908691288c7bea556e378e3577546ee2bf58f71841b8f3e57f6395bc91ef002',
    'runs/promonet/release/generator-00155000':
        '8c003a4df4bc09cd3ac112b33452fb5abfa9516420a42cd02716621109b2b95a'}
RELEASE_CONFIG = 'runs/promonet/synthetic.py'
# The evaluation's pitch threshold (config ERROR_THRESHOLD_PITCH), cents
PITCH_THRESHOLD_CENTS = 50.


def tree_leaves(tree, path=()):
    """(key path, leaf) of a tree of dicts, lists and arrays"""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from tree_leaves(value, path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for index, value in enumerate(tree):
            yield from tree_leaves(value, path + (str(index),))
    else:
        yield '/'.join(path), tree


def tree_digest(tree):
    """SHA-256 over a tree's numpy leaves in the order of their sorted
    key paths: each one's path, dtype, shape and bytes"""
    digest = hashlib.sha256()
    for key, leaf in sorted(tree_leaves(tree), key=lambda item: item[0]):
        array = np.ascontiguousarray(leaf)
        for part in (key, array.dtype.str, str(array.shape)):
            digest.update(part.encode() + b'\0')
        digest.update(array.tobytes())
    return digest.hexdigest()


def state_digest(torch, state):
    """`tree_digest` of a state dict's tensors, read back to the host as
    their bytes, each one's dtype in its key"""
    return tree_digest({
        f'{name}:{value.dtype}': value.detach().cpu().contiguous().reshape(
            -1).view(torch.uint8).numpy()
        for name, value in state.items()})


def within_bf16_bound(torch, kernel, plain):
    """|kernel - plain| <= 2^-5 * (|plain| + 2 * rms(plain)) everywhere

    Four bf16 ulps relative to the element, with a floor at twice the
    output's RMS: where the residual add cancels, a rounding flipped
    early in the chain leaves an error at the scale of the operands, not
    of the small sum.
    """
    floor = 2 * plain.pow(2).mean().sqrt()
    return bool(torch.all(
        (kernel - plain).abs() <= BF16_RTOL * (plain.abs() + floor)).item())


EDIT = dict(
    pitch_shift_cents=400., time_stretch_ratio=1 / 1.4, loudness_scale_db=3.)


# Seconds since the smoke started at each printed line, and the seconds
# between one line and the next summed by the later line's phase
START = time.perf_counter()
PHASE_SECONDS = {}
# Numbers one phase measures and a later one reports beside its own
MEASURED = {}


def emit(**record):
    now = time.perf_counter() - START
    since = now - sum(PHASE_SECONDS.values())
    PHASE_SECONDS[record['phase']] = PHASE_SECONDS.get(
        record['phase'], 0.) + since
    print(json.dumps(dict(record, elapsed_s=now)), flush=True)


def harmonic_audio(seconds, sample_rate, base=180.):
    """The verification signal: 4 harmonics of a vibrato around `base` Hz,
    a third of it deep"""
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    pitch = base + base / 3 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(pitch) / sample_rate
    audio = sum((0.5 ** k) * np.sin(k * phase) for k in range(1, 5))
    return (0.5 * audio / np.abs(audio).max()).astype(np.float32)[None]


def elapsed_ms(torch, function, repeats=10, warmup=2):
    """Mean device time of function() in ms, by CUDA events"""
    for _ in range(warmup):
        function()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        function()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def harmonic_track(seconds, sample_rate, hopsize):
    """Fundamental of `harmonic_audio` at the frame centers, in Hz"""
    frames = int(seconds * sample_rate) // hopsize
    centers = (np.arange(frames) + 0.5) * hopsize / sample_rate
    return 180. + 60. * np.sin(2 * np.pi * 1.5 * centers)


def logfreq_observations(torch, rng, frames, frequencies):
    """K3 check inputs over one frequency axis: random, tie-heavy, masked,
    and masked with a NaN frame or an all -inf frame

    The masked one is built as `preprocess.harmonics.viterbi` builds the
    second harmonic's: magnitudes kept inside the band 1.8..2.25 times a
    moving fundamental, -inf outside, then a log-softmax.
    """
    states = len(frequencies)
    magnitudes = torch.from_numpy(
        np.abs(30 * rng.standard_normal((frames, states)))).float()
    f0 = torch.from_numpy(
        180. + 60. * np.sin(np.arange(frames) / 9.)).float()
    axis = torch.from_numpy(frequencies).float()
    low = torch.searchsorted(axis, f0 * 1.8)
    high = torch.searchsorted(axis, f0 * 2.25)
    columns = torch.arange(states)[None]
    band = (columns >= low[:, None]) & (columns < high[:, None])
    masked = torch.log_softmax(
        torch.where(band, magnitudes, -float('inf')), -1)
    # A frame whose band is empty: all NaN once through the log-softmax,
    # as the harmonics path makes it, or all -inf
    nan_frame, empty_band = masked.clone(), masked.clone()
    nan_frame[frames // 2] = float('nan')
    empty_band[frames // 3] = -float('inf')
    return {
        'random': torch.log_softmax(torch.from_numpy(
            3 * rng.standard_normal((frames, states))).float(), -1),
        'ties': torch.from_numpy(np.round(
            rng.standard_normal((frames, states)))).float(),
        'masked': masked, 'nan_frame': nan_frame, 'empty_band': empty_band}


def block_problem(torch, rng, batch, frames, channels, kernel_size, device):
    weights = torch.from_numpy(
        rng.standard_normal((6, kernel_size, channels, channels)) /
        np.sqrt(kernel_size * channels)).to(device, torch.bfloat16)
    biases = torch.from_numpy(
        0.1 * rng.standard_normal((6, channels))).float().to(device)
    x = torch.from_numpy(rng.standard_normal(
        (batch, frames, channels))).to(device, torch.bfloat16)
    return x, weights, biases


def library_block(torch, x, weights, biases):
    """The same chain through torch.nn.functional.conv1d (cuDNN), bf16"""
    F = torch.nn.functional
    k = weights.shape[1]
    # (conv, k, in, out) → (conv, out, in, k)
    w = weights.permute(0, 3, 2, 1).contiguous()
    b = biases.to(torch.bfloat16)
    x = x.transpose(1, 2)
    for i, d in enumerate(DILATIONS):
        t = F.conv1d(F.leaky_relu(x, 0.1), w[2 * i], b[2 * i],
                     padding=(k - 1) // 2 * d, dilation=d)
        t = F.conv1d(F.leaky_relu(t, 0.1), w[2 * i + 1], b[2 * i + 1],
                     padding=(k - 1) // 2)
        x = x + t
    return x


def block_bound_ms(batch, frames, channels, kernel_size):
    """Least time for one Block: tensor-core flops vs bytes moved once"""
    flops = 2. * batch * frames * channels * channels * kernel_size * 6
    moved = 2. * (2 * batch * frames * channels +
                  6 * kernel_size * channels * channels + 6 * channels)
    return max(flops / PEAK_BF16, moved / PEAK_BYTES) * 1e3, \
        'operations' if flops / PEAK_BF16 > moved / PEAK_BYTES else 'bytes'


def stage_shapes(config, frames):
    """(samples, channels) of each HiFi-GAN upsampling stage's Blocks for
    `frames` input frames"""
    shapes, channels = [], config.HIFIGAN_UPSAMPLE_INITIAL_SIZE
    for rate in config.HIFIGAN_UPSAMPLE_RATES:
        channels, frames = channels // 2, frames * rate
        shapes.append((frames, channels))
    return shapes


def check_blocks(torch, rng, resblock, device, checks, phase='check'):
    """K1 against its plain version at each (frames, channels, kernel
    sizes, (batch, length) pairs) of `checks`, within the bf16 bound; at
    every batch above one the bound must fail once a single bias is
    zeroed. Returns the largest error at batch 1 (0 without one)"""
    error_at_one = 0.
    for frames, channels, kernel_sizes, sizes in checks:
        for kernel_size in kernel_sizes:
            for batch, length in sizes:
                x, weights, biases = block_problem(
                    torch, rng, batch, length, channels, kernel_size, device)
                plain = resblock.reference_block(
                    x, weights, biases, DILATIONS, 0.1, torch.bfloat16
                ).float()
                kernel = resblock.fused_block(
                    x, weights, biases, DILATIONS, 0.1).float()
                torch.cuda.synchronize()
                error = (kernel - plain).abs()
                within = within_bf16_bound(torch, kernel, plain)
                record = dict(
                    phase=phase, kernel='resblock', batch=batch,
                    frames=length, channels=channels,
                    kernel_size=kernel_size,
                    max_abs_err=float(error.max()), within_bound=within)
                if batch > 1:
                    broken = biases.clone()
                    broken[5, torch.argmax(broken[5].abs())] = 0.
                    wrong = resblock.fused_block(
                        x, weights, broken, DILATIONS, 0.1).float()
                    record['zeroed_bias_caught'] = not within_bf16_bound(
                        torch, wrong, plain)
                    within = within and record['zeroed_bias_caught']
                emit(**record)
                if not within:
                    raise AssertionError('resblock kernel disagrees')
                if batch == 1:
                    error_at_one = max(error_at_one, record['max_abs_err'])
    return error_at_one


def check_decodes(viterbi, device, checks, initial, phase='check'):
    """K2 against the plain scan, on the card and on the CPU, at each
    (label, observation, transition) of `checks`: paths equal exactly.
    Returns the largest difference in state index (0)"""
    largest = 0
    for label, observation, matrix in checks:
        batch = observation if observation.dim() == 3 else observation[None]
        plain = np.stack([viterbi.decode(
            sequence.cpu(), matrix.cpu(), initial.cpu()).numpy()
            for sequence in batch])
        on_card_plain = np.stack([
            viterbi.backtrace_plain(*viterbi.forward_plain(
                sequence.to(device), matrix, initial)).cpu().numpy()
            for sequence in batch])
        kernel = viterbi.decode(
            observation.to(device), matrix, initial).cpu().numpy()
        kernel = kernel.reshape(plain.shape)
        equal = bool(np.array_equal(kernel, plain) and
                     np.array_equal(kernel, on_card_plain))
        emit(phase=phase, kernel='viterbi', observation=label,
             frames=observation.shape[-2], equal=equal,
             mismatches=int((kernel != plain).sum()))
        largest = max(
            largest, int(np.abs(kernel - plain).max()),
            int(np.abs(kernel - on_card_plain).max()))
        if not equal:
            raise AssertionError('viterbi kernel disagrees')
    return largest


def launch_counts(resblock, viterbi):
    return {'resblock': resblock.fused_block.launches,
            'viterbi': viterbi.decode.launches,
            'viterbi_logfreq': viterbi.decode_logfreq.launches}


def reset_launch_counts(resblock, viterbi):
    resblock.fused_block.launches = 0
    viterbi.decode.launches = 0
    viterbi.decode_logfreq.launches = 0


def correlation(a, b):
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def device_events(torch, events):
    """The profiler's events that ran on the card: kernels, copies and
    fills, not the annotations of host ranges"""
    return [event for event in events
            if event.device_type == torch.autograd.DeviceType.CUDA and
            not event.is_user_annotation]


def device_busy(torch, function, top=0):
    """Kernels and device time of one function() call under torch.profiler

    Returns {'wall_ms', 'kernels', 'device_busy_ms'}: the host time of the
    profiled call (the profiler's own cost included), the count of device
    events (kernels, copies, fills) and the sum of their durations; the
    last two are None where the profiler recorded no device event. The
    profiler mirrors each host range (the program's `promonet.*` spans)
    on the device's timeline as a user annotation; those are not device
    work and are left out (`device_events`). With
    `top`, also 'top_kernels': the `top` device events by summed time, as
    [name, count, ms].
    """
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as profile:
        start = time.perf_counter()
        function()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = device_events(torch, profile.events())
    result = {
        'wall_ms': wall * 1e3,
        'kernels': len(events) if events else None,
        'device_busy_ms': sum(
            event.time_range.elapsed_us() for event in events) / 1e3
        if events else None}
    if top:
        by_name = {}
        for event in events:
            entry = by_name.setdefault(event.name[:80], [0, 0.])
            entry[0] += 1
            entry[1] += event.time_range.elapsed_us() / 1e3
        result['top_kernels'] = [
            [name, count, ms] for name, (count, ms) in sorted(
                by_name.items(), key=lambda item: -item[1][1])[:top]]
    return result


def timed_call(torch, function, calls=2):
    """The last of `calls` calls of function(), each with the launch counts
    set to 0 just before it: (result, host seconds, launch counts)"""
    from promonet_tpu_torch.ops import resblock, viterbi
    for _ in range(calls):
        reset_launch_counts(resblock, viterbi)
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = function()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = launch_counts(resblock, viterbi)
    return result, seconds, counts


def idle_share(profiled):
    """The share of a profiled call's wall time the card was idle"""
    if profiled['device_busy_ms'] is None:
        return None
    return 1. - profiled['device_busy_ms'] / profiled['wall_ms']


def batched_sets(port, config, device, pitch_model, ppg_model, frames):
    """The batched path's eight feature sets: the 10 s audio extended to
    its bucket, at eight pitch shifts; returns (bucket, sets)"""
    hopsize, sample_rate = config.HOPSIZE, config.SAMPLE_RATE
    bucket = port.data.bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS)
    long_audio = harmonic_audio(
        bucket * hopsize / sample_rate + 1., sample_rate)[:, :bucket * hopsize]
    base = port.preprocess.from_audio(
        long_audio, pitch_model, ppg_model, loudness_bands=None,
        config=config, device=device)
    shifts = (-300., -200., -100., 0., 100., 200., 300., 400.)
    return bucket, [port.edit.from_features(
        *base, pitch_shift_cents=cents, config=config) for cents in shifts]


def serving_paths(torch, port, config, device, audio, features, pitch_model,
                  ppg_model, generator):
    """Phases 7 to 11: batched, windowed and exact-state streaming
    synthesis, the FARGAN and Vocos backbones, and the file-level entry
    points, each at full width; returns each path's launch counts"""
    hopsize, sample_rate = config.HOPSIZE, config.SAMPLE_RATE
    frames = features[1].shape[-1]
    host = [x.cpu().numpy() for x in features]
    path_launches = {}

    def expect(path, counts, expected):
        path_launches[path] = counts
        if counts != expected:
            raise AssertionError(f'{path} launches {counts}')

    # 7. Eight utterances of one bucket in one generator call: the 10 s
    # audio extended to the 896-frame bucket, at eight pitch shifts, so
    # that no padding enters the comparison with single calls
    bucket, sets = batched_sets(
        port, config, device, pitch_model, ppg_model, frames)
    speakers = list(range(len(sets)))
    batched, batched_seconds, counts = timed_call(
        torch, lambda: port.synthesize.from_features_batched(
            sets, generator, speakers=speakers, device=device))
    expect('batched', counts, {'resblock': 12, 'viterbi': 0,
                               'viterbi_logfreq': 0})
    singles, singles_seconds, _ = timed_call(torch, lambda: [
        port.synthesize.from_features(
            *values, generator=generator, speaker=speaker, device=device)
        for values, speaker in zip(sets, speakers)])
    rows_within = []
    relative_rms = []
    for row, single in zip(batched, singles):
        single = torch.from_numpy(single).to(device)
        rows_within.append(within_bf16_bound(torch, row, single))
        relative_rms.append(float(
            (row - single).pow(2).mean().sqrt() / single.pow(2).mean().sqrt()))
    profiled = device_busy(
        torch, lambda: port.synthesize.from_features_batched(
            sets, generator, speakers=speakers, device=device))
    record = dict(
        phase='batched_path', utterances=len(sets), frames=bucket,
        shape=list(batched.shape), ms_per_call=batched_seconds * 1e3,
        ms_per_utterance=batched_seconds * 1e3 / len(sets),
        single_calls_ms=singles_seconds * 1e3,
        single_ms_per_utterance=singles_seconds * 1e3 / len(sets),
        launches=counts, rows_within_bf16_bound=rows_within,
        row_relative_rms_err=relative_rms, profiled_call=profiled,
        finite=bool(torch.isfinite(batched).all()))
    emit(**record)
    if record['shape'] != [len(sets), 1, bucket * hopsize] or \
            not record['finite'] or not all(rows_within):
        raise AssertionError('batched synthesis is wrong')

    # 8. Windowed streaming of the main path's features in 10-frame pieces
    def stream(streamer, step):
        pieces = [streamer.feed(*(x[:, start:start + step] for x in host))
                  for start in range(0, frames, step)]
        pieces.append(streamer.flush())
        return np.concatenate(pieces, axis=-1)

    streamer = port.synthesize.Streamer(generator, speaker=3, device=device)
    if (bucket, streamer.window) != (BATCHED_BUCKET, STREAM_WINDOW):
        raise AssertionError('K1 was checked at other shapes than these')
    streamed, stream_seconds, counts = timed_call(
        torch, lambda: stream(streamer, 10))
    windows = -(-frames // streamer.chunk)
    expect('stream', counts, {'resblock': 12 * windows, 'viterbi': 0,
                              'viterbi_logfreq': 0})
    # One window: a fresh stream fed exactly chunk + right frames
    window = port.synthesize.Streamer(generator, speaker=3, device=device)
    profiled = device_busy(torch, lambda: window.feed(*(
        x[:, :window.chunk + window.right] for x in host)))
    offline = port.synthesize.from_features(
        *features, generator=generator, speaker=3, device=device)
    interior = slice(4096, frames * hopsize - 4096)
    record = dict(
        phase='stream_path', frames=frames, windows=windows,
        window_frames=streamer.window, ms=stream_seconds * 1e3,
        ms_per_window=stream_seconds * 1e3 / windows,
        realtime_factor=frames * hopsize / sample_rate / stream_seconds,
        latency_seconds=streamer.latency_seconds, launches=counts,
        profiled_window=profiled, samples=streamed.shape[-1],
        interior_correlation=correlation(
            streamed[0, interior], offline[0, interior]),
        finite=bool(np.isfinite(streamed).all()))
    emit(**record)
    if streamed.shape != (1, frames * hopsize) or not record['finite'] or \
            record['interior_correlation'] <= 0.9:
        raise AssertionError('streaming synthesis is wrong')

    # 9. FARGAN (configs/fargan.py, bf16): offline, then exact-state
    # streaming in 32-frame chunks
    fargan_config = port.config.load(ROOT / 'configs' / 'fargan.py')
    fargan = port.models.init.seeded(
        port.models.Generator(fargan_config), 4).to(device).eval()
    # K4, FARGAN's subframe as one launch: one a subframe of the bucket
    from promonet_tpu_torch.ops import fargan as fargan_kernel
    subframes = fargan.backbone.subframes
    k4_launches = fargan_kernel.subframe.launches
    offline, offline_seconds, counts = timed_call(
        torch, lambda: port.synthesize.from_features(
            *features, generator=fargan, speaker=3, device=device))
    expect('fargan', counts, {'resblock': 0, 'viterbi': 0,
                              'viterbi_logfreq': 0})
    k4_offline = fargan_kernel.subframe.launches - k4_launches
    chunk = 32
    k4_launches = fargan_kernel.subframe.launches
    chunked, chunked_seconds, counts = timed_call(torch, lambda: stream(
        port.synthesize.FARGANStreamer(
            fargan, speaker=3, chunk_frames=chunk, device=device), chunk))
    k4_chunked = fargan_kernel.subframe.launches - k4_launches
    k4_expected = (
        2 * subframes * port.data.bucket_frames(
            frames, fargan_config.INFERENCE_FRAME_BUCKETS),
        2 * subframes * chunk * -(-frames // chunk))
    if (k4_offline, k4_chunked) != k4_expected:
        raise AssertionError(
            f'FARGAN K4 launches {(k4_offline, k4_chunked)}, expected '
            f'{k4_expected}')
    first_chunk = port.synthesize.FARGANStreamer(
        fargan, speaker=3, chunk_frames=chunk, device=device)
    profiled = device_busy(torch, lambda: first_chunk.feed(*(
        x[:, :chunk] for x in host)))
    if profiled['kernels'] is not None:
        profiled['kernels_per_subframe'] = profiled['kernels'] / (
            chunk * fargan.backbone.subframes)
    difference = np.abs(chunked - offline)
    record = dict(
        phase='fargan_path', frames=frames, dtype=fargan_config.PRECISION,
        offline_ms=offline_seconds * 1e3,
        offline_realtime_factor=(
            frames * hopsize / sample_rate / offline_seconds),
        chunk_frames=chunk, chunked_ms=chunked_seconds * 1e3,
        ms_per_chunk=chunked_seconds * 1e3 / -(-frames // chunk),
        chunked_launches=counts, profiled_chunk=profiled,
        k4_launches={'offline': k4_offline, 'chunked': k4_chunked},
        first_4_frames_max_abs_err=float(difference[..., :4 * hopsize].max()),
        max_abs_err=float(difference.max()),
        correlation=correlation(chunked, offline),
        peak=float(np.abs(offline).max()),
        finite=bool(np.isfinite(offline).all() and np.isfinite(chunked).all()))
    record['within_stated_bound'] = (
        record['first_4_frames_max_abs_err'] <= FARGAN_FIRST_FRAMES_BOUND and
        record['max_abs_err'] <= FARGAN_MAX_ABS_BOUND and
        record['correlation'] >= FARGAN_CORRELATION_BOUND)
    emit(**record)
    if offline.shape != chunked.shape or offline.shape != (
            1, frames * hopsize) or not record['finite'] or \
            not record['within_stated_bound']:
        raise AssertionError('FARGAN synthesis is wrong')
    fargan_kernel_check(torch, port, fargan, features, device,
                        {'offline': k4_offline, 'chunked': k4_chunked})

    # 10. Vocos (configs/baselines/vocos.py, bf16)
    vocos_config = port.config.load(
        ROOT / 'configs' / 'baselines' / 'vocos.py')
    vocos = port.models.init.seeded(
        port.models.Generator(vocos_config), 5).to(device).eval()
    output, vocos_seconds, counts = timed_call(
        torch, lambda: port.synthesize.from_features(
            *features, generator=vocos, speaker=3, device=device))
    expect('vocos', counts, {'resblock': 0, 'viterbi': 0,
                             'viterbi_logfreq': 0})
    profiled = device_busy(torch, lambda: port.synthesize.from_features(
        *features, generator=vocos, speaker=3, device=device))
    record = dict(
        phase='vocos_path', frames=frames, ms=vocos_seconds * 1e3,
        profiled_call=profiled,
        realtime_factor=frames * hopsize / sample_rate / vocos_seconds,
        samples=output.shape[-1], finite=bool(np.isfinite(output).all()))
    emit(**record)
    if output.shape != (1, frames * hopsize) or not record['finite']:
        raise AssertionError('Vocos synthesis is wrong')

    # 11. Files: wav → features → edited features → wav, and the harmonic
    # contours from the wav and the saved pitch
    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as directory:
        directory = Path(directory)
        wav = directory / 'speech.wav'
        port.utils.audio.save(wav, audio, sample_rate)
        infix = '-viterbi' if config.VITERBI_DECODE_PITCH else ''

        def inputs(prefix):
            return [directory / f'{prefix}{name}.npy' for name in (
                '-loudness', f'{infix}-pitch', f'{infix}-periodicity', '-ppg')]

        def files():
            stage_ms = {}
            start = time.perf_counter()
            for stage, function in (
                ('preprocess', lambda: port.preprocess.from_file_to_file(
                    wav, pitch_model, ppg_model, config=config,
                    device=device)),
                ('harmonics', lambda: port.preprocess.harmonics.
                    from_file_to_file(
                        wav, directory / 'speech-harmonics.npy',
                        pitch_file=inputs('speech')[1], config=config,
                        device=device)),
                ('edit', lambda: port.edit.from_file_to_file(
                    *inputs('speech'), directory / 'edited', config=config,
                    device=device, **EDIT)),
                ('synthesize', lambda: port.synthesize.from_file_to_file(
                    *inputs('edited'), directory / 'edited.wav', generator,
                    speaker=3, device=device))):
                function()
                torch.cuda.synchronize()
                stage_ms[stage] = (time.perf_counter() - start) * 1e3
                start = time.perf_counter()
            return stage_ms

        stage_ms, file_seconds, counts = timed_call(torch, files)
        expect('file', counts, {'resblock': 12, 'viterbi': 1,
                                'viterbi_logfreq': 1})
        names = sorted(path.name for path in directory.iterdir())
        expected = sorted(
            [path.name for path in inputs('speech') + inputs('edited')] +
            ['speech.wav', 'speech-harmonics.npy', 'edited.wav'])
        edited_audio, rate = port.utils.audio.load(directory / 'edited.wav')
        harmonics = port.load.array(directory / 'speech-harmonics.npy')
        out_frames = round(frames * 1.4)
        # The edit stage computes on the card, and what it wrote is that
        edited = port.edit.from_file(
            *inputs('speech'), config=config, device=device, **EDIT)
        edited_on = sorted({value.device.type for value in edited})
        edited_as_written = all(
            np.array_equal(value.cpu().numpy(), port.load.array(file))
            for value, file in zip(edited, inputs('edited')))
        record = dict(
            phase='file_path', ms=file_seconds * 1e3, stage_ms=stage_ms,
            files=names, names_as_expected=names == expected,
            samples=edited_audio.shape[-1], sample_rate=rate,
            harmonics_shape=list(harmonics.shape), launches=counts,
            edited_on=edited_on, edited_as_written=edited_as_written)
        emit(**record)
        if edited_on != ['cuda'] or not edited_as_written:
            raise AssertionError('the file edit did not run on the card')
        if names != expected or rate != sample_rate or \
                edited_audio.shape != (1, out_frames * hopsize) or \
                harmonics.shape != (config.MAX_HARMONICS, frames):
            raise AssertionError('file-level entry points are wrong')
    return path_launches


def fargan_kernel_check(torch, port, fargan, features, device, call_sites):
    """K4 against the plain subframe over one offline FARGAN synthesis;
    keeps its entry of the `kernels` line in MEASURED['k4']"""
    from promonet_tpu_torch.models import fargan as models
    from promonet_tpu_torch.ops import fargan as fargan_kernel
    backbone = fargan.backbone
    network = backbone.subframe
    fed, calls = [], []
    handles = [
        backbone.register_forward_pre_hook(
            lambda module, arguments: fed.append(arguments[0])),
        network.register_forward_hook(
            lambda module, arguments, output: calls.append(
                (arguments[:4], output[0], output[1])))]
    launches = fargan_kernel.subframe.launches
    try:
        profiled = device_busy(torch, lambda: port.synthesize.from_features(
            *features, generator=fargan, speaker=3, device=device), top=8)
    finally:
        for handle in handles:
            handle.remove()
    launches = fargan_kernel.subframe.launches - launches
    if len(fed) != 1 or launches != len(calls):
        raise AssertionError(
            f'K4: {len(fed)} backbone calls, {launches} launches for '
            f'{len(calls)} subframes')
    # The fed history: the loop's own samples at its pitch periods
    size, history = backbone.subframe_size, backbone.num_previous
    outputs = torch.cat([call[1] for call in calls], -1).float()
    samples = torch.cat((
        torch.zeros((1, history), device=device), outputs), -1)
    period = torch.clamp(torch.round(fed[0][..., -1]).long(), 1,
                         history - size - 2)
    index = models.lookback_index(period, history, size)
    history_exact = True
    for step, ((_, lookback, previous, _), _, _) in enumerate(calls):
        window = samples[:, step * size:step * size + history]
        history_exact &= bool(
            torch.equal(lookback.float(), torch.gather(
                window, 1, index[:, step // backbone.subframes])) and
            torch.equal(previous.float(), window[:, -size:]))
    # Every subframe against the plain subframe in float32
    inputs = [torch.cat([call[0][k] for call in calls]).float()
              for k in range(3)]
    states = [torch.cat([call[0][3][k] for call in calls]).float()
              for k in range(4)]
    carried = [torch.cat([call[2][k] for call in calls]).float()
               for k in range(4)]
    kernel_outputs = torch.cat([call[1] for call in calls]).float()
    with torch.no_grad():
        plain, plain_states = network.plain(
            *inputs, states, torch.float32, None)
    output_gap = float((kernel_outputs - plain).norm() / plain.norm())
    state_gap = max(float((state - reference).norm() / reference.norm())
                    for state, reference in zip(carried, plain_states))
    max_abs_err = float((kernel_outputs - plain).abs().max())
    # K4's device time a launch, the plain bf16 subframe's time a call
    # (host-paced: about 46 launches) on the first subframe's inputs
    k4 = [(count, ms) for name, count, ms in profiled['top_kernels']
          if 'fargan_subframe' in name]
    ms = k4[0][1] / k4[0][0] if k4 else None
    with torch.no_grad():
        plain_ms = elapsed_ms(torch, lambda: network.plain(
            *calls[0][0], torch.bfloat16, None), repeats=20)
    weights = network.packed().numel()
    operations, moved = 2. * weights, 2. * weights + K4_ROW_BYTES
    record = dict(
        phase='fargan_kernel', subframes=len(calls), launches=launches,
        history_exact=history_exact, output_gap=output_gap,
        state_gap=state_gap, max_abs_err=max_abs_err, ms=ms,
        plain_ms=plain_ms, weights=weights,
        bound_ms=max(operations / PEAK_BF16, moved / PEAK_BYTES) * 1e3,
        bound_by='operations' if operations / PEAK_BF16 >
        moved / PEAK_BYTES else 'bytes', profiled_call=profiled)
    emit(**record)
    if not history_exact or output_gap > FARGAN_K4_OUTPUT_GAP or \
            state_gap > FARGAN_K4_STATE_GAP or ms is None:
        raise AssertionError('K4 is not the plain subframe')
    MEASURED['k4'] = dict(
        name='fargan_subframe', route='cuda',
        source='promonet_tpu_torch/csrc/fargan_subframe.cu', replaces=None,
        launches=launches, launches_by_call_site=call_sites,
        max_abs_err=max_abs_err, output_gap=output_gap, state_gap=state_gap,
        ms=ms, plain_ms=plain_ms, bound_ms=record['bound_ms'],
        bound_by=record['bound_by'], library_ms=None)


def zeroshot_path(torch, port, device, audio, features, edited, pitch_model,
                  ppg_model):
    """Phase 12: zero-shot speakers at full width
    (configs/promonet-zeroshot.py, HiFi-GAN 512, bf16, seeded generator
    and speaker encoder): the x-vector of the 10 s audio, then synthesis
    with x-vectors through from_features, from_features_batched (eight of
    them) and a Streamer; returns each call's launch counts"""
    config = port.config.load(ROOT / 'configs' / 'promonet-zeroshot.py')
    hopsize, sample_rate = config.HOPSIZE, config.SAMPLE_RATE
    speaker = port.preprocess.speaker
    generator = port.models.init.seeded(
        port.models.Generator(config), 6).to(device).eval()
    encoder = port.models.init.seeded(
        port.preprocess.SpeakerEncoder(), 7).to(device).eval()
    launches = {}

    def run(name, function, expected):
        result, seconds, counts = timed_call(torch, function)
        launches[name] = counts
        if counts != expected:
            raise AssertionError(f'zero-shot {name} launches {counts}')
        profiled = device_busy(torch, function)
        return result, dict(ms=seconds * 1e3, launches=counts,
                            profiled_call=profiled,
                            idle_share=idle_share(profiled))

    # The x-vector on the card, against the plain CPU path in float32:
    # unit vectors, held to 1e-4 per element (cuDNN's float32 sums in
    # another order than the CPU's)
    none = {'resblock': 0, 'viterbi': 0, 'viterbi_logfreq': 0}
    xvector, record = run('embedding', lambda: speaker.from_audio(
        audio, encoder, config=config, device=device), none)
    cpu_encoder = port.preprocess.SpeakerEncoder()
    cpu_encoder.load_state_dict(
        {name: value.cpu() for name, value in encoder.state_dict().items()})
    reference = speaker.from_audio(audio, cpu_encoder, config=config,
                                   device='cpu')
    record.update(
        phase='zeroshot_embedding', device=xvector.device.type,
        shape=list(xvector.shape),
        norm=float(torch.linalg.vector_norm(xvector)),
        finite=bool(torch.isfinite(xvector).all()),
        max_abs_err_vs_cpu=float((xvector.cpu() - reference).abs().max()))
    emit(**record)
    if record['device'] != torch.device(device).type or record['shape'] != [
            config.WAVLM_EMBEDDING_CHANNELS] or not record['finite'] or \
            abs(record['norm'] - 1) > 1e-4 or \
            record['max_abs_err_vs_cpu'] > 1e-4:
        raise AssertionError('the speaker embedding is wrong')

    # The main path's edit (bucket 1280) with that x-vector
    k1 = {'resblock': 12, 'viterbi': 0, 'viterbi_logfreq': 0}
    output, record = run(
        'from_features', lambda: port.synthesize.from_features(
            *edited, generator=generator, speaker=xvector, device=device),
        k1)
    frames = edited[1].shape[-1]
    record.update(phase='zeroshot_from_features', frames=frames,
                  samples=output.shape[-1],
                  finite=bool(np.isfinite(output).all()))
    emit(**record)
    if output.shape != (1, frames * hopsize) or not record['finite']:
        raise AssertionError('zero-shot from_features is wrong')

    # Eight x-vectors (of the first 3 to 10 s of the audio) on the batched
    # path's eight sets, one call at B = 8; each row within K1's bf16 bound
    # of its own from_features call
    xvectors = [speaker.from_audio(
        audio[:, :(3 + k) * sample_rate], encoder, config=config,
        device=device) for k in range(8)]
    bucket, sets = batched_sets(
        port, config, device, pitch_model, ppg_model,
        features[1].shape[-1])
    batched, record = run(
        'batched', lambda: port.synthesize.from_features_batched(
            sets, generator, speakers=xvectors, device=device), k1)
    singles = [
        torch.from_numpy(port.synthesize.from_features(
            *values, generator=generator, speaker=vector,
            device=device)).to(device)
        for values, vector in zip(sets, xvectors)]
    rows_within = [within_bf16_bound(torch, row, single)
                   for row, single in zip(batched, singles)]
    record.update(
        phase='zeroshot_batched', utterances=len(sets), frames=bucket,
        shape=list(batched.shape), ms_per_utterance=record['ms'] / len(sets),
        rows_within_bf16_bound=rows_within,
        row_max_abs_err=[float((row - single).abs().max())
                         for row, single in zip(batched, singles)],
        finite=bool(torch.isfinite(batched).all()))
    emit(**record)
    if record['shape'] != [len(sets), 1, bucket * hopsize] or \
            not record['finite'] or not all(rows_within):
        raise AssertionError('zero-shot batched synthesis is wrong')

    # A Streamer with the x-vector, fed the main path's features 10 frames
    # at a time; the audio against one offline call
    host = [x.cpu().numpy() for x in features]
    frames = host[1].shape[-1]

    def stream():
        streamer = port.synthesize.Streamer(
            generator, speaker=xvector, device=device)
        pieces = [streamer.feed(*(x[:, start:start + 10] for x in host))
                  for start in range(0, frames, 10)]
        return np.concatenate(pieces + [streamer.flush()], axis=-1)

    windows = -(-frames // 32)
    streamed, seconds, counts = timed_call(torch, stream)
    launches['stream'] = counts
    window = port.synthesize.Streamer(generator, speaker=xvector,
                                      device=device)
    profiled = device_busy(torch, lambda: window.feed(*(
        x[:, :window.chunk + window.right] for x in host)))
    offline = port.synthesize.from_features(
        *features, generator=generator, speaker=xvector, device=device)
    interior = slice(4096, frames * hopsize - 4096)
    record = dict(
        phase='zeroshot_stream', frames=frames, windows=windows,
        ms=seconds * 1e3, ms_per_window=seconds * 1e3 / windows,
        launches=counts, profiled_window=profiled,
        idle_share=idle_share(profiled), samples=streamed.shape[-1],
        interior_correlation=correlation(
            streamed[0, interior], offline[0, interior]),
        finite=bool(np.isfinite(streamed).all()))
    emit(**record)
    if counts != {'resblock': 12 * windows, 'viterbi': 0,
                  'viterbi_logfreq': 0}:
        raise AssertionError(f'zero-shot stream launches {counts}')
    if streamed.shape != (1, frames * hopsize) or not record['finite'] or \
            record['interior_correlation'] <= 0.9:
        raise AssertionError('zero-shot streaming is wrong')
    return launches


# Each CLI in a process of its own: the stage's `__main__` run as
# `python -m` runs it, then, as the last line of its output, the launch
# counts of that process and the seconds of the package's import and of
# the stage's main code
CLI_RUNNER = """
import json, runpy, sys, time
start = time.perf_counter()
from promonet_tpu_torch.ops import resblock, viterbi
imported = time.perf_counter()
stage = sys.argv.pop(1)
runpy.run_module('promonet_tpu_torch.' + stage, run_name='__main__',
                 alter_sys=True)
print(json.dumps({'launches': {
    'resblock': resblock.fused_block.launches,
    'viterbi': viterbi.decode.launches,
    'viterbi_logfreq': viterbi.decode_logfreq.launches},
    'import_s': imported - start, 'main_s': time.perf_counter() - imported}))
"""

# Seconds each CLI process may take, its start and the kernel load included
CLI_TIMEOUTS = {'preprocess': 180, 'edit': 120, 'synthesize': 150}


def cli_path(torch, port, device, audio, config, pitch_model, ppg_model,
             generator, tf32_defaults):
    """Phase 13: the three CLIs as processes of their own on the card, with
    the smoke's seeded weights written as port checkpoints under build/,
    against the same calls of `from_files_to_files` in this process;
    returns each CLI's launch counts"""
    sample_rate = config.SAMPLE_RATE
    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as directory:
        directory = Path(directory)
        checkpoints = directory / 'checkpoints'
        checkpoint = port.utils.checkpoint
        checkpoint.save(checkpoints / 'pitch-00000001.pt',
                        pitch_model.state_dict(), step=1)
        checkpoint.save(checkpoints / 'ppg-00000002.pt',
                        ppg_model.state_dict(), step=2)
        generator_file = checkpoints / 'generator-00000003.pt'
        checkpoint.save(generator_file, generator.state_dict(), step=3)
        config_file = directory / 'cli.py'
        config_file.write_text(
            "MODULE = 'promonet_tpu_torch'\n"
            f'CHECKPOINTS_DIR = {str(checkpoints)!r}\n')
        cli_config = port.config.load(config_file)
        wav = directory / 'speech.wav'
        port.utils.audio.save(wav, audio, sample_rate)
        cli, ours = directory / 'cli', directory / 'ours'
        cli.mkdir()
        ours.mkdir()
        infix = '-viterbi' if config.VITERBI_DECODE_PITCH else ''

        def inputs(folder, prefix):
            return [folder / f'{prefix}{name}.npy' for name in (
                '-loudness', f'{infix}-pitch', f'{infix}-periodicity',
                '-ppg')]

        def flags(name, files):
            return [f'--{name}', *map(str, files)]

        edit = [value for name, amount in EDIT.items()
                for value in (f'--{name}', repr(amount))]
        stages = (
            ('preprocess',
             ['--files', str(wav), '--output_prefixes', str(cli / 'speech'),
              '--features', 'loudness', 'pitch', 'periodicity', 'ppg',
              'harmonics'],
             {'resblock': 0, 'viterbi': 1, 'viterbi_logfreq': 2}),
            ('edit',
             [*(value for name, file in zip(
                 ('loudness', 'pitch', 'periodicity', 'ppg'),
                 inputs(cli, 'speech')) for value in flags(
                     f'{name}_files', [file])),
              '--output_prefixes', str(cli / 'edited'), *edit],
             {'resblock': 0, 'viterbi': 0, 'viterbi_logfreq': 0}),
            ('synthesize',
             [*(value for name, file in zip(
                 ('loudness', 'pitch', 'periodicity', 'ppg'),
                 inputs(cli, 'edited')) for value in flags(
                     f'{name}_files', [file])),
              '--output_files', str(cli / 'edited.wav'), '--speakers', '3',
              '--checkpoint', str(generator_file)],
             {'resblock': 12, 'viterbi': 0, 'viterbi_logfreq': 0}))
        device = torch.device(device)
        gpu = str(device.index or 0) if device.type == 'cuda' else '-1'
        wall_ms, launches, seconds = {}, {}, {}
        for stage, arguments, expected in stages:
            start = time.perf_counter()
            result = subprocess.run(
                [sys.executable, '-c', CLI_RUNNER, stage, *arguments,
                 '--config', str(config_file), '--gpu', gpu],
                cwd=ROOT, capture_output=True, text=True,
                timeout=CLI_TIMEOUTS[stage])
            wall_ms[stage] = (time.perf_counter() - start) * 1e3
            if result.returncode:
                raise AssertionError(
                    f'the {stage} CLI exited {result.returncode}:\n'
                    f'{result.stderr[-4000:]}')
            report = json.loads(result.stdout.splitlines()[-1])
            launches[stage] = report.pop('launches')
            seconds[stage] = report
            if launches[stage] != expected:
                raise AssertionError(
                    f'the {stage} CLI launched {launches[stage]}')

        # The same stages in this process, each from the CLI's inputs, with
        # PyTorch's default TF32 settings as the CLI processes have them
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32_defaults
        try:
            port.preprocess.from_files_to_files(
                [wav], port.load.pitch_model(config=cli_config, device=device),
                port.load.ppg_model(config=cli_config, device=device),
                [ours / 'speech'], ('loudness', 'pitch', 'periodicity', 'ppg',
                                    'harmonics'),
                config=cli_config, device=device)
            port.edit.from_files_to_files(
                *([file] for file in inputs(cli, 'speech')),
                [ours / 'edited'], config=cli_config, device=device, **EDIT)
            port.synthesize.from_files_to_files(
                *([file] for file in inputs(cli, 'edited')),
                [ours / 'edited.wav'],
                port.load.generator(generator_file, cli_config, device),
                speakers=[3], device=device)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        names = sorted(path.name for path in cli.iterdir())
        difference = {
            name: float(np.abs(
                port.load.array(cli / name) - port.load.array(ours / name)
            ).max())
            for name in names if name.endswith('.npy')}
        # Decoded paths equal (K2: pitch and periodicity; K3: harmonics);
        # the float features within 1e-5 of their scale; the audio within
        # K1's bf16 bound
        decoded = [name for name in names if name.startswith('speech') and (
            'pitch' in name or 'periodicity' in name or 'harmonics' in name)]
        within = all(
            difference[name] <= 1e-5 * max(1., float(np.abs(
                port.load.array(ours / name)).max()))
            for name in difference)
        cli_audio, rate = port.utils.audio.load(cli / 'edited.wav')
        our_audio, _ = port.utils.audio.load(ours / 'edited.wav')
        record = dict(
            phase='cli_path', wall_ms=wall_ms, launches=launches,
            import_and_main_s=seconds,
            files=names,
            names_as_in_process=names == sorted(
                path.name for path in ours.iterdir()),
            max_abs_difference=difference,
            decoded_equal=all(difference[name] == 0 for name in decoded),
            features_within_tolerance=within,
            audio_max_abs_difference=float(np.abs(
                cli_audio - our_audio).max()),
            audio_within_bf16_bound=within_bf16_bound(
                torch, torch.from_numpy(cli_audio),
                torch.from_numpy(our_audio)),
            samples=cli_audio.shape[-1], sample_rate=rate)
        emit(**record)
        out_frames = round(audio.shape[-1] // config.HOPSIZE * 1.4)
        if not record['names_as_in_process'] or len(decoded) != 3 or \
                not record['decoded_equal'] or not within or \
                not record['audio_within_bf16_bound'] or rate != sample_rate \
                or cli_audio.shape != (1, out_frames * config.HOPSIZE):
            raise AssertionError('the CLIs disagree with the in-process calls')
    return launches


# Phase 14: the evaluation's corpus, its kernels' launches per phase and
# the generator calls, counted by the hooks below
CLI_EVALUATE_TIMEOUT = 300


def counted_phases(torch, port):
    """Launch counts and generator calls per evaluation phase: wraps
    `utils.timer.Timer.phase` and hooks every HiFi-GAN forward; returns
    (per-phase counts, the (batch, frames) of every HiFi-GAN input,
    restore)"""
    import contextlib
    from promonet_tpu_torch.ops import resblock, viterbi
    phases, calls, inputs_seen = {}, [0], set()
    original = port.utils.timer.Timer.phase

    def state():
        return {'resblock': resblock.fused_block.launches,
                'viterbi': viterbi.decode.launches,
                'viterbi_logfreq': viterbi.decode_logfreq.launches,
                'generator_calls': calls[0]}

    @contextlib.contextmanager
    def phase(self, name):
        before = state()
        with original(self, name):
            yield
        counts = phases.setdefault(name, dict.fromkeys(before, 0))
        for key, value in state().items():
            counts[key] += value - before[key]

    def hook(module, inputs, output):
        if isinstance(module, port.models.HiFiGAN):
            calls[0] += 1
            inputs_seen.add(tuple(inputs[0].shape[:2]))

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    port.utils.timer.Timer.phase = phase

    def restore():
        handle.remove()
        port.utils.timer.Timer.phase = original

    return phases, inputs_seen, restore


def evaluation_path(torch, port, device, config, pitch_model, ppg_model,
                    generator):
    """Phase 14: the formant corpus made and preprocessed on the card, the
    objective evaluation over it (11 conditions), its metrics and one
    job's edit held against the plain CPU path, the mels baseline's
    evaluation, K1 and K2 against their plain versions at the shapes
    these evaluations gave them, and the evaluate CLI in a process of its
    own; returns the launch counts of each part and the largest K1 error
    at batch 1 and K2 state difference of these checks"""
    from promonet_tpu_torch.ops import resblock, viterbi
    evaluate_core = port.evaluate.core
    hopsize = config.HOPSIZE
    (ROOT / 'build').mkdir(exist_ok=True)
    launches = {}
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as directory:
        directory = Path(directory)
        checkpoints = directory / 'checkpoints'
        checkpoint = port.utils.checkpoint
        checkpoint.save(checkpoints / 'pitch-00000001.pt',
                        pitch_model.state_dict(), step=1)
        # A PPG checkpoint makes a transcriber available
        checkpoint.save(checkpoints / 'ppg-00000002.pt',
                        ppg_model.state_dict(), step=2)
        generator_file = checkpoints / 'generator-00000003.pt'
        checkpoint.save(generator_file, generator.state_dict(), step=3)
        dirs = dict(
            CACHE_DIR=directory / 'cache',
            PARTITIONS_DIR=directory / 'partitions',
            RESULTS_DIR=directory / 'results', EVAL_DIR=directory / 'eval',
            CHECKPOINTS_DIR=checkpoints, RUNS_DIR=directory / 'runs')
        eval_config = config.replace(**dirs)
        ratios = len(eval_config.EVALUATION_RATIOS)
        conditions = 1 + 5 * ratios

        # The corpus: 4 speakers x 3 utterances x 2 s, preprocessed on the
        # card with the seeded extractors, one K2 decode per wav
        reset_launch_counts(resblock, viterbi)
        torch.cuda.synchronize()
        start = time.perf_counter()
        cache = port.data.synthetic.create(
            'synthetic', speakers=4, utterances=3, seconds=2.0,
            config=eval_config, device=device)
        torch.cuda.synchronize()
        corpus_seconds = time.perf_counter() - start
        launches['corpus'] = launch_counts(resblock, viterbi)
        wavs = sorted(cache.glob('*/*.wav'))
        spectrograms = [
            wav.parent / f'{wav.stem}-spectrogram.npy' for wav in wavs]
        record = dict(
            phase='evaluation_corpus', seconds=corpus_seconds,
            utterances=len(wavs), launches=launches['corpus'],
            spectrograms=sum(file.exists() for file in spectrograms))
        emit(**record)
        if launches['corpus'] != {'resblock': 0, 'viterbi': len(wavs),
                                  'viterbi_logfreq': 0} or \
                len(wavs) != 12 or record['spectrograms'] != len(wavs):
            raise AssertionError('the evaluation corpus is wrong')

        # The evaluation, each phase's launches and generator calls counted
        test_stems = port.load.partition(
            'synthetic', False, eval_config)['test']
        jobs = len(test_stems) * conditions
        phases, generator_inputs, restore = counted_phases(
            torch, port)
        try:
            start = time.perf_counter()
            results = port.evaluate.datasets(
                ['synthetic'], checkpoint=generator_file, config=eval_config,
                device=device)['synthetic']
            seconds = time.perf_counter() - start
        finally:
            restore()
        launches['evaluate'] = phases
        objective = results['objective']
        generator_calls = sum(
            counts['generator_calls'] for counts in phases.values())
        # The output buckets of the jobs: a group each, per speaker
        ladder = evaluate_core._coarse_bucket_ladder(
            'synthetic', {'': test_stems}, eval_config)
        exported = directory / 'eval' / 'objective'
        buckets = {}
        for file in exported.glob('*/*-pitch.npy'):
            speaker_id = file.name.split('-')[1]
            frames = np.load(file).shape[-1]
            buckets.setdefault(speaker_id, set()).add(
                port.data.bucket_frames(frames, ladder))
        finite = all(
            np.isfinite(values[name]).all() for values in objective.values()
            for name in ('periodicity', 'ppg')) and all(
            np.isfinite(value) for values in objective.values()
            for value in values['loudness'].values())
        wav_count = len(list((directory / 'eval' / 'subjective').glob(
            '*/*.wav')))
        npy_count = len(list(exported.glob('*/*.npy')))
        record = dict(
            phase='evaluation', seconds=seconds, jobs=jobs,
            ladder=ladder, bucket_groups=sum(map(len, buckets.values())),
            generator_calls=generator_calls, launches=phases,
            benchmark=results['benchmark'],
            audio_seconds=results['num_samples'] / config.SAMPLE_RATE,
            conditions=sorted(objective), finite=finite,
            objective_reconstructed=objective['reconstructed'],
            wavs=wav_count, npys=npy_count)
        emit(**record)
        if len(objective) != conditions or not finite or \
                set(results['benchmark']) != {
                    'load', 'warmup', 'edit', 'generate', 'preprocess',
                    'transcribe'} or \
                wav_count != jobs + len(test_stems) or npy_count != 4 * jobs:
            raise AssertionError('the evaluation results are wrong')
        if phases['preprocess']['viterbi'] != jobs or any(
                counts['resblock'] != 12 * counts['generator_calls']
                for counts in phases.values()):
            raise AssertionError(f'the evaluation launched {phases}')

        # The card's idle share over one job's re-preprocess at the run's
        # top bucket
        wav = next((directory / 'eval' / 'subjective' / 'reconstructed'
                    ).glob('*.wav'))
        audio = port.load.audio(wav, config)
        padded = np.zeros((1, max(ladder) * hopsize), np.float32)
        padded[:, :audio.shape[-1]] = audio
        run_config = eval_config.replace(INFERENCE_FRAME_BUCKETS=ladder)
        models = evaluate_core._models(generator_file, run_config, device)

        def preprocess_job():
            return port.preprocess.from_audio(
                padded, models[0], models[1],
                features=evaluate_core.PREDICTED, loudness_bands=None,
                config=run_config, device=device)

        card_features = [value.cpu() for value in preprocess_job()]
        profiled = device_busy(torch, preprocess_job)

        # The same re-preprocess through the plain CPU path in float32,
        # held as phase 5 holds it; then K2 at the top bucket's length on
        # the card's and the CPU's pitch observations of it and on a
        # random one, paths equal exactly to the plain scan's
        cpu_models = (port.preprocess.PitchCNN(), port.preprocess.PPGEncoder())
        for copy, model in zip(cpu_models, models[:2]):
            copy.load_state_dict(
                {k: v.cpu() for k, v in model.state_dict().items()})
            copy.eval()
        cpu_features = port.preprocess.from_audio(
            padded, *cpu_models, features=evaluate_core.PREDICTED,
            loudness_bands=None,
            config=run_config.replace(PRECISION='float32'), device='cpu')
        cents = 1200 * torch.abs(
            torch.log2(card_features[1] / cpu_features[1]))
        preprocess_error = dict(
            frames=card_features[1].shape[-1],
            loudness_max_abs_db=float(
                (card_features[0] - cpu_features[0]).abs().max()),
            ppg_max_abs=float(
                (card_features[3] - cpu_features[3]).abs().max()),
            pitch_share_within_1_cent=float((cents < 1).float().mean()),
            periodicity_share_within_0_001=float((
                (card_features[2] - cpu_features[2]).abs() < 1e-3
            ).float().mean()))
        pitch_module = port.preprocess.pitch
        with torch.inference_mode():
            observations = [
                torch.log_softmax(pitch_module.cnn_posteriorgram(
                    model, torch.from_numpy(padded).to(where), hopsize
                ).float(), -1).cpu()
                for model, where in ((models[0], device),
                                     (cpu_models[0], 'cpu'))]
        top = max(ladder)
        if {observation.shape for observation in observations} != {
                (top, pitch_module.CANDIDATES)}:
            raise AssertionError('the top bucket gave other pitch frames')
        transition = viterbi.triangular_transition(
            pitch_module.CANDIDATES, pitch_module.TRANSITION_WIDTH).to(device)
        initial = torch.full(
            (pitch_module.CANDIDATES,),
            -float(np.log(np.float32(pitch_module.CANDIDATES))),
            device=device)
        rng = np.random.default_rng(14)
        k2_error = check_decodes(viterbi, device, [
            ('top_bucket_card', observations[0], transition),
            ('top_bucket_cpu', observations[1], transition),
            ('top_bucket_random', torch.log_softmax(torch.from_numpy(
                3 * rng.standard_normal((top, pitch_module.CANDIDATES))
            ).float(), -1), transition)], initial, 'evaluation_check')

        # The card's metrics, recomputed on the CPU from the exported
        # files and each job's edit (made on the card, as the evaluation
        # makes it), against results.json
        def edit_job(stem, condition, where):
            features, frames = evaluate_core._load_features(
                cache, stem, run_config, where)
            shift, stretch, scale, _, _ = evaluate_core._conditions(
                run_config)[condition]
            *edited, frames = port.edit.from_padded_features(
                *features, frames, shift, stretch, scale, run_config)
            return [value[..., :frames].cpu() for value in edited]

        differences = {}
        for condition in objective:
            metrics = port.evaluate.Metrics(include_wer=False,
                                            config=run_config)
            for pitch_file in sorted(
                    (exported / condition).glob('*-pitch.npy')):
                prefix = str(pitch_file)[:-len('-pitch.npy')]
                predicted = [np.load(f'{prefix}-{name}.npy') for name in (
                    'loudness', 'pitch', 'periodicity', 'ppg')]
                parts = pitch_file.name.split('-')
                edited = [value.numpy() for value in edit_job(
                    f'{parts[1]}/{parts[2]}-{parts[3]}', condition, device)]
                metrics.update(
                    edited[0].mean(axis=-2), predicted[0].mean(axis=-2),
                    edited[1], edited[2], predicted[1], predicted[2],
                    edited[3], predicted[3])
            for name, value in metrics().items():
                card = objective[condition][name]
                pairs = value.items() if isinstance(value, dict) else [
                    (name, value)]
                for key, number in pairs:
                    reported = card[key] if isinstance(card, dict) else card
                    differences[f'{condition}/{key}'] = abs(
                        number - reported) / max(abs(reported), 1e-12)
        worst = max(differences, key=differences.get)

        # One job's edit stage on the card and on the CPU
        card_edit, cpu_edit = (
            edit_job(test_stems[0], 'stretched-141', where)
            for where in (device, 'cpu'))
        edit_error = dict(
            loudness_max_abs_db=float(
                (card_edit[0] - cpu_edit[0]).abs().max()),
            pitch_max_abs_cents=float((1200 * torch.log2(
                card_edit[1] / cpu_edit[1])).abs().max()),
            periodicity_max_abs=float(
                (card_edit[2] - cpu_edit[2]).abs().max()),
            ppg_max_abs=float((card_edit[3] - cpu_edit[3]).abs().max()))
        record = dict(
            phase='evaluation_reference',
            metrics_max_relative_difference=differences[worst],
            metrics_worst=worst, edit_vs_cpu=edit_error,
            preprocess_vs_cpu=preprocess_error,
            profiled_preprocess=profiled, idle_share=idle_share(profiled))
        emit(**record)
        if differences[worst] > 1e-6 or \
                preprocess_error['loudness_max_abs_db'] >= 0.05 or \
                preprocess_error['ppg_max_abs'] >= 1e-3 or \
                edit_error['loudness_max_abs_db'] > 0.05 or \
                edit_error['ppg_max_abs'] > 1e-3 or \
                edit_error['pitch_max_abs_cents'] > 1. or \
                edit_error['periodicity_max_abs'] > 1e-3:
            raise AssertionError('the evaluation disagrees with the CPU')

        # The mels baseline on the same corpus: 'reconstructed' alone, one
        # MelGenerator call (12 Blocks) per test stem
        mels_config = port.config.load(
            ROOT / 'configs' / 'baselines' / 'mels.py').replace(**dict(
                dirs, EVAL_DIR=directory / 'eval-mels',
                HIFIGAN_UPSAMPLE_INITIAL_SIZE=(
                    config.HIFIGAN_UPSAMPLE_INITIAL_SIZE),
                PRECISION=config.PRECISION))
        mel_generator = port.models.init.seeded(
            port.models.MelGenerator(mels_config), 9).to(device).eval()
        mels_file = checkpoints / 'mels' / 'generator-00000009.pt'
        checkpoint.save(mels_file, mel_generator.state_dict(), step=9)
        phases, mels_inputs, restore = counted_phases(
            torch, port)
        try:
            start = time.perf_counter()
            mels = port.evaluate.datasets(
                ['synthetic'], checkpoint=mels_file, config=mels_config,
                device=device)['synthetic']
            mels_seconds = time.perf_counter() - start
        finally:
            restore()
        launches['mels'] = phases
        spectrogram = np.load(
            cache / f'{test_stems[0]}-spectrogram.npy')
        reference = port.models.MelGenerator(
            mels_config.replace(PRECISION='float32'))
        reference.load_state_dict(
            {k: v.cpu() for k, v in mel_generator.state_dict().items()})
        mels_card = port.baseline.mels.from_features(
            spectrogram, mel_generator, speaker=0, device=device)
        mels_cpu = port.baseline.mels.from_features(
            spectrogram, reference, speaker=0, device='cpu')
        relative_rms = float(np.sqrt(
            np.mean((mels_card - mels_cpu) ** 2) / np.mean(mels_cpu ** 2)))
        reconstructed = mels['objective']['reconstructed']
        record = dict(
            phase='evaluation_mels', seconds=mels_seconds,
            launches=phases, benchmark=mels['benchmark'],
            conditions=sorted(mels['objective']),
            objective_reconstructed=reconstructed,
            audio_relative_rms_err=relative_rms,
            wavs=sorted({wav.parent.name for wav in (
                directory / 'eval-mels' / 'subjective').glob('*/*.wav')}))
        emit(**record)
        stems = len(test_stems)
        if len(mels['objective']) != conditions or \
                record['wavs'] != ['original', 'reconstructed'] or \
                not np.isfinite(reconstructed['ppg']) or \
                phases['generate'] != {
                    'resblock': 12 * stems, 'viterbi': 0,
                    'viterbi_logfreq': 0, 'generator_calls': stems} or \
                phases['preprocess']['viterbi'] != stems or \
                relative_rms >= 0.05:
            raise AssertionError('the mels evaluation is wrong')

        # The WORLD baseline on the same corpus: every condition, each
        # job generated on the host from the stem's wav and preprocessed
        # again on the card, one K2 decode per job and no K1
        world_config = port.config.load(
            ROOT / 'configs' / 'baselines' / 'world.py').replace(**dict(
                dirs, EVAL_DIR=directory / 'eval-world'))
        phases, _, restore = counted_phases(torch, port)
        try:
            start = time.perf_counter()
            world = port.evaluate.datasets(
                ['synthetic'], config=world_config,
                device=device)['synthetic']
            world_seconds = time.perf_counter() - start
        finally:
            restore()
        launches['world'] = phases
        world_objective = world['objective']
        finite = all(
            np.isfinite(values[name]).all()
            for values in world_objective.values()
            for name in ('periodicity', 'ppg')) and all(
            np.isfinite(value) for values in world_objective.values()
            for value in values['loudness'].values())
        # One job's audio against the baseline called on the CPU with the
        # same input: the stem's wav and the job's edited pitch
        stem = test_stems[0]
        stem_features, stem_frames = evaluate_core._load_features(
            cache, stem, world_config.replace(
                INFERENCE_FRAME_BUCKETS=evaluate_core._coarse_bucket_ladder(
                    'synthetic', {'': test_stems}, world_config)), 'cpu')
        shift = evaluate_core._conditions(world_config)['shifted-141'][0]
        pitch = port.edit.from_padded_features(
            *stem_features, stem_frames, shift, None, None, world_config)[1]
        expected = port.baseline.world.from_audio(
            port.load.audio(cache / f'{stem}.wav', world_config),
            pitch=pitch[..., :stem_frames].numpy(), config=world_config)
        written, _ = port.utils.audio.load(
            directory / 'eval-world' / 'subjective' / 'shifted-141' /
            f'synthetic-{stem.replace("/", "-")}-shifted-141.wav')
        world_error = float(np.abs(written - expected).max())
        record = dict(
            phase='evaluation_world', seconds=world_seconds, jobs=jobs,
            launches=phases, benchmark=world['benchmark'],
            conditions=sorted(world_objective), finite=finite,
            objective_reconstructed=world_objective['reconstructed'],
            job_max_abs_err_vs_cpu_call=world_error)
        emit(**record)
        if len(world_objective) != conditions or not finite or \
                phases['preprocess']['viterbi'] != jobs or any(
                    counts['resblock'] or counts['generator_calls']
                    for counts in phases.values()) or \
                written.shape != expected.shape or \
                world_error > 2 / 32768:
            raise AssertionError('the WORLD evaluation is wrong')

        # K1 at every (batch, frames) that the evaluation's and the mels
        # baseline's HiFi-GAN calls gave it (bucket groups are filled to
        # the batch size), held to the bf16 bound with the zeroed-bias
        # control
        k1_checks = [
            (frames, channels, KERNEL_SIZES, ((batch, frames),))
            for inputs_seen, path_config in (
                (generator_inputs, eval_config), (mels_inputs, mels_config))
            for batch, bucket in sorted(inputs_seen)
            for frames, channels in stage_shapes(path_config, bucket)]
        k1_error = check_blocks(
            torch, rng, resblock, device, k1_checks, 'evaluation_check')
        emit(phase='evaluation_kernels',
             generator_inputs=sorted(generator_inputs),
             mels_inputs=sorted(mels_inputs),
             k1_checks=sum(
                 len(kernel_sizes) * len(sizes)
                 for _, _, kernel_sizes, sizes in k1_checks),
             k1_max_abs_err_at_batch_1=k1_error,
             k2_max_state_difference=k2_error)

        # The evaluate CLI in a process of its own
        config_file = directory / 'cli.py'
        config_file.write_text("MODULE = 'promonet_tpu_torch'\n" + ''.join(
            f'{name} = {str(value)!r}\n' for name, value in dict(
                dirs, RESULTS_DIR=directory / 'cli-results',
                EVAL_DIR=directory / 'cli-eval').items()) +
            f'HIFIGAN_UPSAMPLE_INITIAL_SIZE = '
            f'{config.HIFIGAN_UPSAMPLE_INITIAL_SIZE}\n'
            f'PRECISION = {config.PRECISION!r}\n')
        device = torch.device(device)
        gpu = str(device.index or 0) if device.type == 'cuda' else '-1'
        start = time.perf_counter()
        result = subprocess.run(
            [sys.executable, '-m', 'promonet_tpu_torch.evaluate',
             '--datasets', 'synthetic', '--gpu', gpu,
             '--max_stems', '1', '--checkpoint', str(generator_file),
             '--config', str(config_file)],
            cwd=ROOT, capture_output=True, text=True,
            timeout=CLI_EVALUATE_TIMEOUT)
        wall = time.perf_counter() - start
        if result.returncode:
            raise AssertionError(
                f'the evaluate CLI exited {result.returncode}:\n'
                f'{result.stderr[-4000:]}')
        written = json.loads((
            directory / 'cli-results' / config.CONFIG / 'synthetic' /
            'results.json').read_text())
        record = dict(
            phase='evaluation_cli', wall_s=wall,
            conditions=sorted(written['objective']),
            same_conditions=sorted(written['objective']) == sorted(objective),
            benchmark=written['benchmark'])
        emit(**record)
        if not record['same_conditions']:
            raise AssertionError('the evaluate CLI wrote other conditions')

        # The corpus's preprocessing and each of the four
        # evaluate.datasets calls (the evaluation, the mels and WORLD
        # baselines, the CLI) reported its start and end
        statuses = notifications(eval_config.RUNS_DIR)
        MEASURED['evaluation_notifications'] = statuses
        emit(phase='evaluation_notifications', records=statuses)
        if statuses != [['preprocess', 'started'],
                        ['preprocess', 'completed']] + [
                            ['evaluate', 'started'],
                            ['evaluate', 'completed']] * 4:
            raise AssertionError('the evaluation was not notified')
    return launches, k1_error, k2_error


def notifications(runs_dir):
    """[job, status] of each record of RUNS_DIR's notifications.jsonl"""
    return [
        [record['job'], record['status']] for record in map(
            json.loads, (Path(runs_dir) / 'notifications.jsonl').read_text(
            ).splitlines())]


# The training corpus: 16 speakers x 6 utterances x 1 s, of which the
# partition of `data.synthetic.create` keeps four per speaker for
# training (64 stems, one batch, 192 items with their augmented copies)
# and one for validation (16 items, DEFAULT_EVALUATION_STEPS)
TRAIN_CORPUS = dict(speakers=16, utterances=6, seconds=1.0)
# Adaptation: one speaker of 12 utterances, two held out for its test
# partition; its train partition (10 stems and their 20 augmented copies)
# takes batches of 16
ADAPT_CORPUS = dict(speakers=1, utterances=12, seconds=1.0)
ADAPT_BATCH_SIZE = 16


def train_batch(config, seed, batch=2, frames=8):
    """A numpy-seeded training batch of `frames` frames"""
    rng = np.random.default_rng(seed)
    ppg = rng.random((batch, config.PPG_CHANNELS, frames)).astype(np.float32)
    bins = config.NUM_FFT // 2 + 1
    return {
        'loudness': rng.uniform(-80, 0, (batch, bins, frames)).astype(
            np.float32),
        'pitch': rng.uniform(80, 300, (batch, frames)).astype(np.float32),
        'periodicity': rng.random((batch, frames)).astype(np.float32),
        'ppg': ppg / ppg.sum(1, keepdims=True),
        'speakers': np.arange(batch, dtype=np.int32),
        'spectral_balance_ratios': np.ones(batch, np.float32),
        'loudness_ratios': np.ones(batch, np.float32),
        'spectrograms': np.abs(rng.standard_normal(
            (batch, bins, frames))).astype(np.float32) + 1e-3,
        'audio': (0.3 * rng.standard_normal(
            (batch, 1, frames * config.HOPSIZE))).astype(np.float32)}


def corpus_config(config, directory, **overrides):
    """The configuration over phase 15's corpus and extractors under
    `directory`, with `overrides`"""
    directory = Path(directory)
    return config.replace(**dict(dict(
        CACHE_DIR=directory / 'cache',
        PARTITIONS_DIR=directory / 'partitions',
        AUGMENT_DIR=directory / 'augmentations',
        RESULTS_DIR=directory / 'results', EVAL_DIR=directory / 'eval',
        RUNS_DIR=directory / 'runs', CHECKPOINTS_DIR=directory / 'checkpoints',
        NUM_WORKERS=8), **overrides))


def training_path(torch, port, device, config, pitch_model, ppg_model,
                  edited, directory):
    """Phase 15: GAN training at full width on a formant corpus made on
    the card, its validation through K1 and K2, auto-resume, an edit
    served from the trained checkpoint, K1 and K2 held to their plain
    versions at the validation's shapes, one narrow float32 step on the
    card against the same step on the CPU, and one speaker's adaptation
    through evaluate.datasets(adapt=True); its corpus, cache and runs go
    to `directory`, which the extractors' phases read after it; returns
    the launch counts of each part and the largest K1 error at batch 1 and
    K2 state difference of these checks"""
    from promonet_tpu_torch.ops import resblock, viterbi
    train_core = sys.modules['promonet_tpu_torch.train.core']
    hopsize = config.HOPSIZE
    launches = {}
    directory = Path(directory)
    checkpoints = directory / 'checkpoints'
    checkpoint = port.utils.checkpoint
    checkpoint.save(checkpoints / 'pitch-00000001.pt',
                    pitch_model.state_dict(), step=1)
    checkpoint.save(checkpoints / 'ppg-00000002.pt',
                    ppg_model.state_dict(), step=2)
    # The host loader, which earlier recorded step times were taken with
    train_config = corpus_config(config, directory, RESIDENT_DATA=False)

    # The corpus, augmented on the host and preprocessed on the card:
    # one K2 decode per wav, originals and copies
    reset_launch_counts(resblock, viterbi)
    start = time.perf_counter()
    cache = port.data.synthetic.create(
        'synthetic', **TRAIN_CORPUS, preprocess=False,
        config=train_config, device=device)
    synthesized = time.perf_counter() - start
    port.data.augment.datasets(['synthetic'], train_config)
    augmented = time.perf_counter() - start - synthesized
    port.data.preprocess.core.datasets(
        ['synthetic'], pitch_model=pitch_model, ppg_model=ppg_model,
        config=train_config, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches['corpus'] = launch_counts(resblock, viterbi)
    wavs = sorted(cache.glob('*/*.wav'))
    train_items = len(port.data.Dataset(
        'synthetic', 'train', train_config))
    partition = port.load.partition('synthetic', False, train_config)
    record = dict(
        phase='training_corpus', seconds=seconds,
        synthesis_seconds=synthesized, augmentation_seconds=augmented,
        wavs=len(wavs), train_stems=len(partition['train']),
        train_items=train_items, valid_stems=len(partition['valid']),
        launches=launches['corpus'])
    emit(**record)
    if len(partition['train']) < train_config.BATCH_SIZE or \
            len(wavs) != 3 * TRAIN_CORPUS['speakers'] * \
            TRAIN_CORPUS['utterances'] or \
            launches['corpus']['viterbi'] != len(wavs):
        raise AssertionError('the training corpus is wrong')

    # Training, each step timed on the card, its launches counted; the
    # validation's launches and HiFi-GAN inputs counted apart
    steps, validations, inputs_seen, partitions, captured = \
        [], [], set(), [], []
    original_from_audio = port.preprocess.from_audio

    def callback(step, metrics):
        steps[-1].update(step=step, losses={
            k: float(v) for k, v in metrics.items() if k.startswith('loss/')})

    def capture(audio, *args, **kwargs):
        if not captured:
            captured.append(audio.detach().clone())
        return original_from_audio(audio, *args, **kwargs)

    run = train_config.RUNS_DIR / train_config.CONFIG
    restore = counted_training(
        torch, port, steps, validations, inputs_seen, partitions)
    port.preprocess.from_audio = capture
    try:
        results = {}
        for label, stop in (('train', 3), ('resume', 5)):
            reset_launch_counts(resblock, viterbi)
            first = len(steps)
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            state = port.train(
                run, 'synthetic', steps=stop, config=train_config,
                device=device, callback=callback)
            torch.cuda.synchronize()
            results[label] = dict(
                seconds=time.perf_counter() - start,
                steps=[entry['step'] for entry in steps[first:]],
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    finally:
        restore()
        port.preprocess.from_audio = original_from_audio
    step_ms = [
        entry['events'][0].elapsed_time(entry['events'][1])
        for entry in steps]
    # The first step of each call builds cuDNN's plans: not timed
    timed = [ms for entry, ms in zip(steps, step_ms)
             if entry['step'] not in (0, 3)]
    finite = all(np.isfinite(value) for entry in steps
                 for value in entry['losses'].values())
    record = dict(
        phase='training', batch=train_config.BATCH_SIZE,
        chunk=train_config.CHUNK_SIZE, precision=train_config.PRECISION,
        remat=train_config.REMAT,
        width=train_config.HIFIGAN_UPSAMPLE_INITIAL_SIZE,
        discriminators=[type(d).__name__ for d in
                        state.discriminator.discriminators],
        runs=results, step_ms=step_ms, median_step_ms=float(
            np.median(timed)),
        steps_per_second=1e3 / float(np.median(timed)),
        losses={entry['step']: entry['losses']['loss/generator/total']
                for entry in steps},
        discriminator_losses={
            entry['step']: entry['losses']['loss/discriminator/total']
            for entry in steps},
        finite=finite,
        step_launches=[entry['launches'] for entry in steps],
        validations=validations, validation_inputs=sorted(inputs_seen),
        checkpoints=sorted(path.name for path in run.glob('*.pt')))
    emit(**record)
    MEASURED['host_loader_median_step_ms'] = record['median_step_ms']
    launches['training_steps'] = [entry['launches'] for entry in steps]
    launches['validation'] = validations
    resumed = checkpoint.load(run / 'generator-00000005.pt')
    items = train_config.DEFAULT_EVALUATION_STEPS
    if not finite or results['train']['steps'] != [0, 1, 2] or \
            results['resume']['steps'] != [3, 4] or \
            resumed['step'] != 5 or resumed['optimizer']['step'] != 5:
        raise AssertionError('training did not run or resume as it must')
    if any(entry['launches']['resblock'] for entry in steps):
        raise AssertionError('a training step launched the block kernel')
    if partitions != ['train', 'valid'] * 2:
        raise AssertionError(f'the host loader read {partitions}')
    if len(validations) != 1 or validations[0]['launches'] != {
            'resblock': 12 * validations[0]['generator_calls'],
            'viterbi': items, 'viterbi_logfreq': 0} or \
            validations[0]['generator_calls'] != items:
        raise AssertionError(f'validation launched {validations}')

    # One profiled step: the card's idle share
    loader = port.data.loader(
        'synthetic', 'train', train_config, native=True)
    batch = train_core.to_device(next(iter(loader)), device)
    profiled = device_busy(torch, lambda: train_core.train_step(
        state, batch), top=12)
    emit(phase='training_profile', profiled_step=profiled,
         idle_share=idle_share(profiled))

    # An edit served from the trained checkpoint, through K1
    trained = port.load.generator(
        run / 'generator-00000005.pt', train_config, device)
    reset_launch_counts(resblock, viterbi)
    output = port.synthesize.from_features(
        *edited, generator=trained, speaker=3, device=device)
    torch.cuda.synchronize()
    launches['trained_edit'] = launch_counts(resblock, viterbi)
    frames = edited[1].shape[-1]
    record = dict(
        phase='training_edit', launches=launches['trained_edit'],
        samples=output.shape[-1], finite=bool(np.isfinite(output).all()))
    emit(**record)
    if not record['finite'] or output.shape != (1, frames * hopsize) or \
            launches['trained_edit']['resblock'] != 12:
        raise AssertionError('the trained checkpoint does not serve')

    # K1 at every (batch, frames) validation fed it (batches of one,
    # so without the zeroed-bias control, as phase 14 at batch 1), and
    # the same stages at batch 2 with the control; K2 on the card's and
    # the CPU's pitch observations of one validation item's audio and
    # a random one of that length
    rng = np.random.default_rng(16)
    k1_checks = [
        (frames, channels, KERNEL_SIZES, ((batch, frames), (2, frames)))
        for batch, bucket in sorted(inputs_seen)
        for frames, channels in stage_shapes(train_config, bucket)]
    k1_error = check_blocks(
        torch, rng, resblock, device, k1_checks, 'training_check')
    pitch_module = port.preprocess.pitch
    cpu_pitch = port.preprocess.PitchCNN()
    cpu_pitch.load_state_dict(
        {k: v.cpu() for k, v in pitch_model.state_dict().items()})
    cpu_pitch.eval()
    waveform = captured[0].reshape(1, -1)
    with torch.inference_mode():
        observations = [
            torch.log_softmax(pitch_module.cnn_posteriorgram(
                model, waveform.to(where), hopsize).float(), -1).cpu()
            for model, where in ((pitch_model, device),
                                 (cpu_pitch, 'cpu'))]
    transition = viterbi.triangular_transition(
        pitch_module.CANDIDATES, pitch_module.TRANSITION_WIDTH).to(device)
    initial = torch.full(
        (pitch_module.CANDIDATES,),
        -float(np.log(np.float32(pitch_module.CANDIDATES))),
        device=device)
    length = observations[0].shape[0]
    k2_error = check_decodes(viterbi, device, [
        ('validation_card', observations[0], transition),
        ('validation_cpu', observations[1], transition),
        ('validation_random', torch.log_softmax(torch.from_numpy(
            3 * rng.standard_normal((length, pitch_module.CANDIDATES))
        ).float(), -1), transition)], initial, 'training_check')
    emit(phase='training_kernels', validation_inputs=sorted(inputs_seen),
         k1_checks=sum(len(kernel_sizes) * len(sizes)
                       for _, _, kernel_sizes, sizes in k1_checks),
         k1_max_abs_err_at_batch_1=k1_error,
         k2_frames=length, k2_max_state_difference=k2_error)

    # One narrow float32 step on the card against the same step on the
    # CPU, from the same seeded state
    narrow = config.replace(
        HIFIGAN_UPSAMPLE_INITIAL_SIZE=32, CHUNK_SIZE=2048, BATCH_SIZE=2,
        PRECISION='float32')
    narrow_batch = train_batch(narrow, 17)
    metrics = {}
    for where in ('cpu', device):
        narrow_state = train_core.create_state(narrow, where)
        metrics[str(where)] = {
            name: float(value) for name, value in train_core.train_step(
                narrow_state, train_core.to_device(
                    narrow_batch, torch.device(where))).items()}
    card, cpu = metrics[str(device)], metrics['cpu']
    relative = {
        name: abs(card[name] - value) / max(abs(value), 1e-12)
        for name, value in cpu.items() if name.startswith('loss/')}
    worst = max(relative, key=relative.get)
    emit(phase='training_reference', losses_card=card, losses_cpu=cpu,
         max_relative_difference=relative[worst], worst=worst)
    if relative[worst] > 1e-4:
        raise AssertionError('the card trains otherwise than the CPU')

    # One speaker's adaptation: ADAPTATION_STEPS 2 from the trained
    # checkpoint (step 5), then its test-adapt stems evaluated
    adapt_config = train_config.replace(
        BATCH_SIZE=ADAPT_BATCH_SIZE, STEPS=5, ADAPTATION_STEPS=2)
    port.data.synthetic.create(
        'adaptation', **ADAPT_CORPUS, preprocess=False,
        config=adapt_config, device=device)
    port.data.augment.datasets(['adaptation'], adapt_config)
    port.data.preprocess.core.datasets(
        ['adaptation'], pitch_model=pitch_model, ppg_model=ppg_model,
        config=adapt_config, device=device)
    port.partition.adaptation_partitions('adaptation', 2, adapt_config)
    phases, adapt_inputs, restore = counted_phases(torch, port)
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        adapted = port.evaluate.datasets(
            ['adaptation'], checkpoint=run / 'generator-00000005.pt',
            adapt=True, config=adapt_config, device=device)['adaptation']
        torch.cuda.synchronize()
        adapt_seconds = time.perf_counter() - start
    finally:
        restore()
    launches['adaptation'] = phases
    adapted_run = (adapt_config.RUNS_DIR / adapt_config.CONFIG / 'adapt' /
                   'adaptation' / '00')
    payload = checkpoint.load(adapted_run / 'generator-00000007.pt')
    objective = adapted['objective']
    record = dict(
        phase='adaptation', seconds=adapt_seconds,
        speakers=sorted(adapted['speakers']), conditions=sorted(objective),
        run=sorted(path.name for path in adapted_run.glob('*.pt')),
        step=payload['step'], launches=phases,
        benchmark=adapted['benchmark'],
        objective_reconstructed=objective['reconstructed'])
    emit(**record)
    if record['speakers'] != ['00'] or payload['step'] != 7 or \
            len(objective) != 1 + 5 * len(config.EVALUATION_RATIOS) or \
            not np.isfinite(objective['reconstructed']['ppg']) or any(
                counts['resblock'] != 12 * counts['generator_calls']
                for counts in phases.values()):
        raise AssertionError('the adaptation is wrong')
    return launches, k1_error, k2_error


def counted_training(torch, port, steps, validations, inputs_seen,
                     partitions):
    """Wrap the trainer for a phase: each `train_step` timed by CUDA events
    and its launches counted (appended to `steps`), each validation's
    generator calls, launches and HiFi-GAN inputs counted (`validations`,
    `inputs_seen`), and the partitions the host loader is asked for
    (`partitions`); returns the function that restores it"""
    from promonet_tpu_torch.ops import resblock, viterbi
    train_core = sys.modules['promonet_tpu_torch.train.core']
    original_step = train_core.train_step
    original_evaluate = train_core.evaluate
    original_loader = port.data.loader

    def timed_step(*args, **kwargs):
        before = launch_counts(resblock, viterbi)
        start_event = torch.cuda.Event(enable_timing=True)
        end_event = torch.cuda.Event(enable_timing=True)
        start_event.record()
        metrics = original_step(*args, **kwargs)
        end_event.record()
        after = launch_counts(resblock, viterbi)
        steps.append({'events': (start_event, end_event),
                      'launches': {k: after[k] - before[k] for k in after}})
        return metrics

    def counted_evaluate(*args, **kwargs):
        before = launch_counts(resblock, viterbi)
        calls = [0]

        def hook(module, inputs, output):
            if isinstance(module, port.models.HiFiGAN):
                calls[0] += 1
                inputs_seen.add(tuple(inputs[0].shape[:2]))

        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        start = time.perf_counter()
        try:
            original_evaluate(*args, **kwargs)
            torch.cuda.synchronize()
        finally:
            handle.remove()
        after = launch_counts(resblock, viterbi)
        validations.append(dict(
            seconds=time.perf_counter() - start, generator_calls=calls[0],
            launches={k: after[k] - before[k] for k in after}))

    def loader(dataset, partition, *args, **kwargs):
        partitions.append(partition)
        return original_loader(dataset, partition, *args, **kwargs)

    train_core.train_step = timed_step
    train_core.evaluate = counted_evaluate
    port.data.loader = loader

    def restore():
        train_core.train_step = original_step
        train_core.evaluate = original_evaluate
        port.data.loader = original_loader

    return restore


def resident_training_path(torch, port, device, config, directory):
    """Phase 15a: the default configuration trained at full width from the
    device-resident corpus, which RESIDENT_DATA = None turns on for the
    card: phase 15's training partition packed on the host and copied to
    the card once; `crops` on the card against the CPU for the same rows
    and starts (equal) and 4096 draws within their stems; `train` for 4
    steps (STEPS_PER_DISPATCH auto: one dispatch of 4) with validation at
    step 0, resumed to 6 with STEPS_PER_DISPATCH = 2, each step timed by
    CUDA events; the host loader asked for the validation partition
    alone; one profiled dispatch; K1 held to its plain version at the
    validation's shapes. Returns the launch counts of each part and the
    largest K1 error at batch 1"""
    from promonet_tpu_torch.ops import resblock, viterbi
    train_core = sys.modules['promonet_tpu_torch.train.core']
    resident = port.data.resident
    directory = Path(directory)
    train_config = corpus_config(
        config, directory, RUNS_DIR=directory / 'runs-resident')
    if not train_core.resident_data(train_config, device):
        raise AssertionError('RESIDENT_DATA = None is not resident on the card')
    chunk_frames = train_config.CHUNK_SIZE // train_config.HOPSIZE
    launches = {}

    # The partition packed on the host, then copied to the card once
    start = time.perf_counter()
    packed = resident.pack('synthetic', 'train', train_config)
    pack_seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    start = time.perf_counter()
    data = resident.to_device(packed, device)
    torch.cuda.synchronize()
    upload_seconds = time.perf_counter() - start
    card_bytes = sum(
        tensor.numel() * tensor.element_size() for tensor in data.values())

    # The gather on the card against the CPU, and the starts in range
    sampler = torch.Generator(device=device).manual_seed(5)
    rows, starts = resident.draw(
        data, sampler, train_config.BATCH_SIZE, chunk_frames)
    card = resident.crops(data, rows, starts, chunk_frames)
    cpu = resident.crops(
        {name: torch.from_numpy(value) for name, value in packed.items()},
        rows.cpu(), starts.cpu(), chunk_frames)
    crops_equal = {
        name: bool(torch.equal(card[name].cpu(), value))
        for name, value in cpu.items()}
    many_rows, many_starts = resident.draw(data, sampler, 4096, chunk_frames)
    within = bool((
        (many_starts >= 0) &
        (many_starts <= data['lengths'][many_rows] - chunk_frames)).all())
    record = dict(
        phase='resident_corpus', stems=len(packed['lengths']),
        card_bytes=card_bytes, card_gb=card_bytes / 1e9,
        pack_seconds=pack_seconds, upload_seconds=upload_seconds,
        crops_equal_to_cpu=crops_equal, starts_within_stems=within,
        distinct_stems_in_4096_draws=len(set(many_rows.tolist())))
    emit(**record)
    if not all(crops_equal.values()) or not within:
        raise AssertionError('the resident crops are wrong')

    # Training: 4 steps in one dispatch, then resumed to 6 in two
    steps, validations, inputs_seen, partitions, callbacks = \
        [], [], set(), [], []

    def callback(step, metrics):
        callbacks.append((step, {
            name: float(value) for name, value in metrics.items()
            if name.startswith('loss/')}))

    run = train_config.RUNS_DIR / train_config.CONFIG
    restore = counted_training(
        torch, port, steps, validations, inputs_seen, partitions)
    try:
        results = {}
        for label, stop, dispatch in (('train', 4, None), ('resume', 6, 2)):
            run_config = train_config.replace(STEPS_PER_DISPATCH=dispatch)
            first, first_callback = len(steps), len(callbacks)
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            state = port.train(
                run, 'synthetic', steps=stop, config=run_config,
                device=device, callback=callback)
            torch.cuda.synchronize()
            results[label] = dict(
                seconds=time.perf_counter() - start,
                steps_per_dispatch=train_core.steps_per_dispatch(
                    stop, run_config),
                steps=len(steps) - first,
                callbacks=[step for step, _ in callbacks[first_callback:]],
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    finally:
        restore()
    step_ms = [entry['events'][0].elapsed_time(entry['events'][1])
               for entry in steps]
    # The first step of each call builds cuDNN's plans: not timed
    timed = [ms for i, ms in enumerate(step_ms) if i not in (0, 4)]
    finite = all(np.isfinite(value) for _, losses in callbacks
                 for value in losses.values())
    resumed = port.utils.checkpoint.load(run / 'generator-00000006.pt')
    launches['resident_steps'] = [entry['launches'] for entry in steps]
    launches['validation'] = validations
    items = train_config.DEFAULT_EVALUATION_STEPS
    median = float(np.median(timed))
    record = dict(
        phase='resident_training', batch=train_config.BATCH_SIZE,
        chunk=train_config.CHUNK_SIZE, precision=train_config.PRECISION,
        remat=train_config.REMAT,
        width=train_config.HIFIGAN_UPSAMPLE_INITIAL_SIZE, runs=results,
        step_ms=step_ms, median_step_ms=median,
        steps_per_second=1e3 / median,
        host_loader_median_step_ms=MEASURED.get(
            'host_loader_median_step_ms'),
        losses=callbacks, finite=finite,
        host_loader_partitions=partitions,
        step_launches=launches['resident_steps'], validations=validations,
        validation_inputs=sorted(inputs_seen),
        checkpoints=sorted(path.name for path in run.glob('*.pt')))
    emit(**record)
    if not finite or [results[label]['steps_per_dispatch'] for label in
                      ('train', 'resume')] != [4, 2] or \
            [results[label]['steps'] for label in ('train', 'resume')] != \
            [4, 2] or results['train']['callbacks'] != [3] or \
            results['resume']['callbacks'] != [5] or \
            resumed['step'] != 6 or resumed['optimizer']['step'] != 6:
        raise AssertionError('resident training did not run or resume')
    if partitions != ['valid', 'valid']:
        raise AssertionError(f'the host loader read {partitions}')
    if any(entry['launches']['resblock'] for entry in steps):
        raise AssertionError('a resident step launched the block kernel')
    if len(validations) != 1 or validations[0]['launches'] != {
            'resblock': 12 * items, 'viterbi': items,
            'viterbi_logfreq': 0} or \
            validations[0]['generator_calls'] != items:
        raise AssertionError(f'validation launched {validations}')

    # One dispatch of two steps, as the trainer runs it, profiled
    def dispatch():
        for _ in range(2):
            batch = resident.sample(
                data, sampler, train_config.BATCH_SIZE, train_config)
            batch['spectrograms'] = port.preprocess.spectrogram.from_audio(
                batch['audio'], train_config)
            train_core.train_step(state, batch)

    profiled = device_busy(torch, dispatch, top=8)
    emit(phase='resident_profile', profiled_dispatch=profiled,
         idle_share=idle_share(profiled),
         device_events_per_step=None if profiled['kernels'] is None
         else profiled['kernels'] / 2)

    # K1 at the validation's (batch, frames), and at batch 2 with the
    # zeroed-bias control
    rng = np.random.default_rng(19)
    k1_checks = [
        (frames, channels, KERNEL_SIZES, ((batch, frames), (2, frames)))
        for batch, bucket in sorted(inputs_seen)
        for frames, channels in stage_shapes(train_config, bucket)]
    k1_error = check_blocks(
        torch, rng, resblock, device, k1_checks, 'resident_check')
    del data, state
    torch.cuda.empty_cache()
    return launches, k1_error


def pause_notify_path(torch, port, device, config, directory):
    """Phase 15b: a resident run of 8 steps (dispatches of 2) on a thread;
    after its second dispatch this thread takes `utils.pause.exclusive`
    (the trainer's callback waits for the request, so that the trainer
    meets it at step 4): the trainer must acknowledge, having written a
    checkpoint at step 4, and take no step while paused (its step count and a
    checksum of the generator's trainable weights the same across 2 s);
    released, the run finishes. notifications.jsonl must hold this
    train's start and completion, and that of phase 14 each of its
    evaluate.datasets calls'. Returns the launch counts of the run"""
    from promonet_tpu_torch.ops import resblock, viterbi
    train_core = sys.modules['promonet_tpu_torch.train.core']
    pause = port.utils.pause
    directory = Path(directory)
    train_config = corpus_config(
        config, directory, RUNS_DIR=directory / 'runs-pause',
        STEPS_PER_DISPATCH=2, DEFAULT_EVALUATION_STEPS=2)
    run = train_config.RUNS_DIR / train_config.CONFIG
    total = 8
    taken, states, errors = [0], [], []
    progressed, finished = threading.Event(), threading.Event()
    original_step = train_core.train_step

    def counting_step(state, batch, **kwargs):
        if not states:
            states.append(state)
        taken[0] += 1
        return original_step(state, batch, **kwargs)

    def callback(step, metrics):
        # After the second dispatch, wait for the request: the trainer
        # then meets it at the next dispatch's pause check
        if step == 3:
            progressed.set()
            deadline = time.perf_counter() + 300
            while not pause.pause_file(train_config).exists() and \
                    time.perf_counter() < deadline:
                time.sleep(0.001)

    def training():
        try:
            port.train(run, 'synthetic', steps=total, config=train_config,
                       device=device, callback=callback)
        except Exception as error:
            errors.append(error)
        finally:
            progressed.set()
            finished.set()

    def checksum():
        with torch.no_grad():
            return sum(float(tensor.double().sum())
                       for tensor in states[0].trainable.values())

    reset_launch_counts(resblock, viterbi)
    train_core.train_step = counting_step
    try:
        thread = threading.Thread(target=training, daemon=True)
        thread.start()
        progressed.wait(900)
        if errors or not progressed.is_set():
            raise AssertionError(f'the paused run did not start: {errors}')
        requested = time.perf_counter()
        with pause.exclusive(
                timeout=300, poll_seconds=0.01, config=train_config) as acked:
            latency = time.perf_counter() - requested
            paused_at = taken[0]
            held = [(taken[0], checksum())]
            time.sleep(2.)
            held.append((taken[0], checksum()))
            saved = sorted(path.name for path in run.glob('generator-*.pt'))
        finished.wait(900)
    finally:
        train_core.train_step = original_step
    if errors or not finished.is_set():
        raise AssertionError(f'the paused run did not finish: {errors}')
    thread.join(60)
    launches = launch_counts(resblock, viterbi)
    final = port.utils.checkpoint.load(run / f'generator-{total:08d}.pt')
    statuses = notifications(train_config.RUNS_DIR)
    record = dict(
        phase='pause_notify', acknowledged=acked,
        request_to_ack_seconds=latency, paused_at_step=paused_at,
        held=held, checkpoints_while_paused=saved, final_step=final['step'],
        steps_taken=taken[0], notifications=statuses,
        evaluation_notifications=MEASURED.get('evaluation_notifications'),
        protocol_files_left=sorted(
            path.name for path in train_config.RUNS_DIR.iterdir()
            if path.name in ('PAUSE', 'PAUSE.ack', 'trainer.pid')),
        launches=launches)
    emit(**record)
    if not acked or held[0] != held[1] or paused_at != 4 or \
            f'generator-{paused_at:08d}.pt' not in saved or \
            final['step'] != total or taken[0] != total or \
            statuses != [['train', 'started'], ['train', 'completed']] or \
            record['protocol_files_left']:
        raise AssertionError('the pause or the notifications are wrong')
    return launches


def data_parallel_path(torch, port, device, config, directory):
    """Phase 15c: a process group of one rank under NCCL (a FileStore under
    build/): `train` at full width for 2 steps (one resident dispatch),
    its all-reduces counted and its metrics finite; then from the same
    seeded state and batch two steps without the group, whose spread is
    the card's run-to-run bound, and one step as rank 0 of the group, whose
    losses must lie within that spread or 1e-3 relative. Returns the
    launch counts of the run"""
    import torch.distributed as dist
    from promonet_tpu_torch.ops import resblock, viterbi
    train_core = sys.modules['promonet_tpu_torch.train.core']
    parallel = port.parallel
    resident = port.data.resident
    directory = Path(directory)
    train_config = corpus_config(
        config, directory, RUNS_DIR=directory / 'runs-parallel',
        DEFAULT_EVALUATION_STEPS=2)
    dist.init_process_group(
        'nccl', init_method=f'file://{directory / "store"}', rank=0,
        world_size=1)
    try:
        mesh = parallel.create_mesh(config=train_config, device=device)
        losses = []
        reset_launch_counts(resblock, viterbi)
        issued = parallel.all_reduce_mean.launches
        start = time.perf_counter()
        port.train(
            train_config.RUNS_DIR / train_config.CONFIG, 'synthetic',
            steps=2, config=train_config, device=device,
            callback=lambda step, metrics: losses.append({
                name: float(value) for name, value in metrics.items()}))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        issued = parallel.all_reduce_mean.launches - issued
        launches = launch_counts(resblock, viterbi)

        # The same state and batch, without the group and as its rank 0
        data = resident.to_device(
            resident.pack('synthetic', 'train', train_config), device)
        batch = resident.sample(
            data, torch.Generator(device=device).manual_seed(13),
            train_config.BATCH_SIZE, train_config)
        batch['spectrograms'] = port.preprocess.spectrogram.from_audio(
            batch['audio'], train_config)
        steps = {}
        for label in ('unsharded', 'unsharded_again', 'rank_0_of_1'):
            state = train_core.create_state(train_config, device)
            if label == 'rank_0_of_1':
                state.mesh = mesh
            steps[label] = {
                name: float(value) for name, value in
                train_core.average_metrics(train_core.train_step(
                    state, batch), state.mesh).items()
                if name.startswith('loss/')}
            del state
        del data, batch
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    def relative(a, b):
        return max(abs(a[name] - b[name]) / max(abs(b[name]), 1e-12)
                   for name in b)

    spread = relative(steps['unsharded_again'], steps['unsharded'])
    difference = relative(steps['rank_0_of_1'], steps['unsharded'])
    record = dict(
        phase='data_parallel', backend='nccl', world=mesh.world,
        mesh=mesh.shape, seconds=seconds, all_reduces=issued,
        losses=losses, finite=all(
            np.isfinite(value) for entry in losses
            for value in entry.values()),
        steps=steps, run_to_run_spread=spread,
        rank_0_of_1_difference=difference,
        bound=max(spread, 1e-3), launches=launches)
    emit(**record)
    # One dispatch of two steps: two gradient buckets a step, the metrics
    if not record['finite'] or issued != 5 or len(losses) != 1 or \
            difference > record['bound'] or dist.is_initialized():
        raise AssertionError('the data-parallel run is wrong')
    return launches


def plot_path(torch, port, device, config, directory, encoder):
    """Phase 22a: the speaker encoder's embeddings (on the card) of phase
    15's 96 utterances, laid out by `plot.umap.UMAP` on the host (seconds,
    and the ratio of the mean distance to the own speaker's centroid to
    the mean distance between centroids); where matplotlib imports, the
    prosody figure of one validation item and the speaker figure saved
    under build/figures/"""
    train_config = corpus_config(config, directory)
    cache = train_config.CACHE_DIR / 'synthetic'
    wavs = sorted(
        path for path in cache.glob('*/*.wav') if path.stem.endswith('-100'))
    torch.cuda.synchronize()
    start = time.perf_counter()
    embeddings = np.stack([
        port.preprocess.speaker.from_audio(
            port.load.audio(wav, train_config), encoder,
            config=train_config, device=device).float().cpu().numpy().reshape(
                -1)
        for wav in wavs])
    embed_seconds = time.perf_counter() - start
    labels = np.array([int(wav.parent.name) for wav in wavs])
    start = time.perf_counter()
    layout = port.plot.umap.UMAP().fit_transform(embeddings)
    umap_seconds = time.perf_counter() - start
    centroids = {label: layout[labels == label].mean(0)
                 for label in np.unique(labels)}
    within = float(np.mean([
        np.linalg.norm(point - centroids[label])
        for point, label in zip(layout, labels)]))
    between = float(np.mean([
        np.linalg.norm(centroids[a] - centroids[b])
        for a in centroids for b in centroids if a < b]))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        figures = 'matplotlib not installed'
    else:
        output = ROOT / 'build' / 'figures'
        output.mkdir(parents=True, exist_ok=True)
        stem = port.load.partition('synthetic', False, train_config)[
            'valid'][0]
        port.plot.from_file_to_file(
            output / 'prosody.png', audio_file=cache / f'{stem}.wav',
            prefix=cache / stem, target_prefix=cache / stem,
            config=train_config)
        figure = port.plot.speaker.from_embeddings(embeddings, labels)
        figure.savefig(output / 'speakers.png')
        import matplotlib.pyplot as plt
        plt.close(figure)
        figures = sorted(str(path.relative_to(ROOT))
                         for path in output.glob('*.png'))
    record = dict(
        phase='plot', utterances=len(wavs), speakers=len(centroids),
        embedding_seconds=embed_seconds, umap_seconds=umap_seconds,
        within_to_between_centroid_distance=within / between,
        finite=bool(np.isfinite(layout).all()), figures=figures)
    emit(**record)
    if len(wavs) != TRAIN_CORPUS['speakers'] * TRAIN_CORPUS['utterances'] \
            or not record['finite'] or layout.shape != (len(wavs), 2):
        raise AssertionError('the speaker layout is wrong')


# FARGAN's training corpus: 16 speakers x 8 utterances x 1 s; the
# partition keeps six per speaker for training (96 stems, 288 items with
# their augmented copies: one batch of configs/fargan.py's 256) and one
# for validation (16 items, DEFAULT_EVALUATION_STEPS)
FARGAN_CORPUS = dict(speakers=16, utterances=8, seconds=1.0)


def shared_noise(torch, seed):
    """A FARGAN noise source that draws the same values for a tensor on
    any device: uniform draws from a seeded CPU generator, then moved"""
    generator = torch.Generator().manual_seed(seed)
    return lambda x: torch.rand(
        x.shape, generator=generator, dtype=x.dtype).to(x.device)


def fargan_training_path(torch, port, device, config, pitch_model,
                         ppg_model):
    """Phase 16: FARGAN trained at full width (configs/fargan.py: batch 256
    x 4096 samples, bf16, the period and complex multi-band discriminators
    from step 0, spectral-convergence loss) on a formant corpus made on
    the card, 3 steps with validation at step 0, then resumed to step 5;
    one profiled step; one narrow float32 step on the card against the
    same step on the CPU with the same noise. Returns the launch counts of
    each part"""
    from promonet_tpu_torch.ops import resblock, viterbi
    train_core = sys.modules['promonet_tpu_torch.train.core']
    (ROOT / 'build').mkdir(exist_ok=True)
    launches = {}
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as directory:
        directory = Path(directory)
        checkpoints = directory / 'checkpoints'
        checkpoint = port.utils.checkpoint
        checkpoint.save(checkpoints / 'pitch-00000001.pt',
                        pitch_model.state_dict(), step=1)
        checkpoint.save(checkpoints / 'ppg-00000002.pt',
                        ppg_model.state_dict(), step=2)
        train_config = port.config.load(
            ROOT / 'configs' / 'fargan.py').replace(
            CACHE_DIR=directory / 'cache',
            PARTITIONS_DIR=directory / 'partitions',
            AUGMENT_DIR=directory / 'augmentations',
            RUNS_DIR=directory / 'runs', CHECKPOINTS_DIR=checkpoints,
            NUM_WORKERS=8, RESIDENT_DATA=False)

        reset_launch_counts(resblock, viterbi)
        start = time.perf_counter()
        cache = port.data.synthetic.create(
            'synthetic', **FARGAN_CORPUS, preprocess=False,
            config=train_config, device=device)
        port.data.augment.datasets(['synthetic'], train_config)
        port.data.preprocess.core.datasets(
            ['synthetic'], pitch_model=pitch_model, ppg_model=ppg_model,
            config=train_config, device=device)
        torch.cuda.synchronize()
        launches['corpus'] = launch_counts(resblock, viterbi)
        wavs = sorted(cache.glob('*/*.wav'))
        train_items = len(port.data.Dataset(
            'synthetic', 'train', train_config))
        partition = port.load.partition('synthetic', False, train_config)
        emit(phase='fargan_training_corpus',
             seconds=time.perf_counter() - start, wavs=len(wavs),
             train_stems=len(partition['train']), train_items=train_items,
             valid_stems=len(partition['valid']),
             launches=launches['corpus'])
        if train_items < train_config.BATCH_SIZE or \
                len(partition['valid']) != \
                train_config.DEFAULT_EVALUATION_STEPS or \
                launches['corpus']['viterbi'] != len(wavs):
            raise AssertionError('the FARGAN training corpus is wrong')

        steps, validations, last, batches = [], [], {}, []
        original_step = train_core.train_step
        original_evaluate = train_core.evaluate

        def timed_step(*args, **kwargs):
            start_event = torch.cuda.Event(enable_timing=True)
            end_event = torch.cuda.Event(enable_timing=True)
            start_event.record()
            metrics = original_step(*args, **kwargs)
            end_event.record()
            steps.append({'events': (start_event, end_event)})
            batches[:] = [args[1]]
            return metrics

        def callback(step, metrics):
            torch.cuda.synchronize()
            now = launch_counts(resblock, viterbi)
            steps[-1].update(
                step=step, launches={k: now[k] - last.get(k, 0) for k in now},
                losses={k: float(v) for k, v in metrics.items()
                        if k.startswith('loss/')})
            last.update(now)

        def counted_evaluate(*args, **kwargs):
            before = launch_counts(resblock, viterbi)
            calls = [0]

            def hook(module, inputs, output):
                if isinstance(module, port.models.fargan.FARGAN):
                    calls[0] += 1

            handle = torch.nn.modules.module.register_module_forward_hook(
                hook)
            start = time.perf_counter()
            try:
                original_evaluate(*args, **kwargs)
                torch.cuda.synchronize()
            finally:
                handle.remove()
            after = launch_counts(resblock, viterbi)
            validations.append(dict(
                seconds=time.perf_counter() - start, generator_calls=calls[0],
                launches={k: after[k] - before[k] for k in after}))
            last.update(after)

        run = train_config.RUNS_DIR / train_config.CONFIG
        train_core.train_step = timed_step
        train_core.evaluate = counted_evaluate
        try:
            results = {}
            for label, stop in (('train', 3), ('resume', 5)):
                reset_launch_counts(resblock, viterbi)
                last.clear()
                first = len(steps)
                torch.cuda.reset_peak_memory_stats()
                start = time.perf_counter()
                state = port.train(
                    run, 'synthetic', steps=stop, config=train_config,
                    device=device, callback=callback)
                torch.cuda.synchronize()
                results[label] = dict(
                    seconds=time.perf_counter() - start,
                    steps=[entry['step'] for entry in steps[first:]],
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        finally:
            train_core.train_step = original_step
            train_core.evaluate = original_evaluate
        step_ms = [
            entry['events'][0].elapsed_time(entry['events'][1])
            for entry in steps]
        timed = [ms for entry, ms in zip(steps, step_ms)
                 if entry['step'] not in (0, 3)]
        finite = all(np.isfinite(value) for entry in steps
                     for value in entry['losses'].values())
        emit(phase='fargan_training', batch=train_config.BATCH_SIZE,
             chunk=train_config.CHUNK_SIZE,
             precision=train_config.PRECISION,
             discriminators=[type(d).__name__ for d in
                             state.discriminator.discriminators],
             runs=results, step_ms=step_ms,
             median_step_ms=float(np.median(timed)),
             steps_per_second=1e3 / float(np.median(timed)),
             losses={entry['step']: entry['losses'] for entry in steps},
             finite=finite,
             step_launches=[entry['launches'] for entry in steps],
             validations=validations,
             checkpoints=sorted(path.name for path in run.glob('*.pt')))
        launches['training_steps'] = [entry['launches'] for entry in steps]
        launches['validation'] = validations
        resumed = checkpoint.load(run / 'generator-00000005.pt')
        items = train_config.DEFAULT_EVALUATION_STEPS
        if not finite or results['train']['steps'] != [0, 1, 2] or \
                results['resume']['steps'] != [3, 4] or \
                resumed['step'] != 5 or resumed['optimizer']['step'] != 5 or \
                'loss/generator/spectral-convergence' not in steps[0][
                    'losses'] or \
                'loss/discriminator/total' not in steps[0]['losses']:
            raise AssertionError('FARGAN did not train or resume as it must')
        if any(entry['launches']['resblock'] for entry in steps):
            raise AssertionError('a FARGAN step launched the block kernel')
        if len(validations) != 1 or validations[0]['launches'] != {
                'resblock': 0, 'viterbi': items, 'viterbi_logfreq': 0} or \
                validations[0]['generator_calls'] != items:
            raise AssertionError(f'FARGAN validation launched {validations}')

        # One more step on the last batch, profiled
        profiled = device_busy(torch, lambda: train_core.train_step(
            state, batches[0]), top=12)
        emit(phase='fargan_training_profile', profiled_step=profiled,
             idle_share=idle_share(profiled))

        # One narrow float32 step on the card against the same step on the
        # CPU: the same seeded state, batch and noise
        narrow = train_config.replace(
            BATCH_SIZE=2, CHUNK_SIZE=1536, PRECISION='float32')
        narrow_batch = train_batch(narrow, 17, frames=6)
        metrics = {}
        for where in ('cpu', device):
            narrow_state = train_core.create_state(narrow, where)
            metrics[str(where)] = {
                name: float(value) for name, value in train_core.train_step(
                    narrow_state, train_core.to_device(
                        narrow_batch, torch.device(where)),
                    noise=shared_noise(torch, 18)).items()}
        card, cpu = metrics[str(device)], metrics['cpu']
        relative = {
            name: abs(card[name] - value) / max(abs(value), 1e-12)
            for name, value in cpu.items() if name.startswith('loss/')}
        worst = max(relative, key=relative.get)
        emit(phase='fargan_training_reference', losses_card=card,
             losses_cpu=cpu, max_relative_difference=relative[worst],
             worst=worst)
        if relative[worst] > 1e-4:
            raise AssertionError(
                'the card trains FARGAN otherwise than the CPU')
    return launches


EXPORT_RUNNER = """
import json, sys, time
import numpy as np
import torch
start = time.perf_counter()
import promonet_tpu_torch
from promonet_tpu_torch.ops import resblock
imported = time.perf_counter()
program = torch.export.load(sys.argv[1]).module()
loaded = time.perf_counter()
x = torch.from_numpy(np.load(sys.argv[2])).cuda()
resblock.fused_block.launches = 0
with torch.inference_mode():
    audio = program(x)
    torch.cuda.synchronize()
    first = time.perf_counter()
    launches = resblock.fused_block.launches
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        program(x)
    begin.record()
    for _ in range(10):
        program(x)
    end.record()
    torch.cuda.synchronize()
np.save(sys.argv[3], audio.float().cpu().numpy())
print(json.dumps({
    'launches': launches, 'import_s': imported - start,
    'load_s': loaded - imported, 'first_call_s': first - loaded,
    'ms': begin.elapsed_time(end) / 10,
    'device': torch.cuda.get_device_name(0)}))
"""

# Frames of the exported program's input: the JAX package's buffer of
# 8192 samples
EXPORT_FRAMES = 8192 // 256


def export_path(torch, port, device, config, features, generator):
    """Phase 17: `python -m promonet_tpu_torch.models.export` on the main
    path's seeded checkpoint in a process of its own, the program loaded
    and run in a second process on the main path's features packed at 32
    frames (12 K1 calls, within the bf16 bound of eager
    `packed_inference`), K1 against its plain version at that program's
    Block shapes, and `python -m promonet_tpu_torch.data.pack` on those
    features saved under the cache's names; returns (launch counts, the
    largest K1 error of these checks)"""
    from promonet_tpu_torch.models import export
    from promonet_tpu_torch.ops import resblock, viterbi
    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as directory:
        directory = Path(directory)
        generator_file = directory / 'generator-00000003.pt'
        port.utils.checkpoint.save(
            generator_file, generator.state_dict(), step=3)
        gpu = str(torch.device(device).index or 0)
        start = time.perf_counter()
        result = subprocess.run(
            [sys.executable, '-m', 'promonet_tpu_torch.models.export',
             '--checkpoint', str(generator_file), '--output_file',
             str(directory / 'exported'), '--gpu', gpu],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        export_wall = time.perf_counter() - start
        if result.returncode:
            raise AssertionError(
                f'the export CLI exited {result.returncode}:\n'
                f'{result.stderr[-4000:]}')

        # The main path's features, their first 32 frames packed
        loudness, pitch, periodicity, ppg = (
            value[..., :EXPORT_FRAMES][None] if value.dim() == 2 else
            value[..., :EXPORT_FRAMES] for value in features)
        packed = export.pack_features(
            loudness, pitch.reshape(1, -1), periodicity.reshape(1, -1), ppg,
            torch.tensor([3], device=device),
            torch.tensor([1.], device=device),
            torch.tensor([1.], device=device), config)
        np.save(directory / 'packed.npy', packed.cpu().numpy())
        start = time.perf_counter()
        result = subprocess.run(
            [sys.executable, '-c', EXPORT_RUNNER,
             str(directory / 'exported.pt2'),
             str(directory / 'packed.npy'), str(directory / 'audio.npy')],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        load_wall = time.perf_counter() - start
        if result.returncode:
            raise AssertionError(
                f'the exported program did not run ({result.returncode}):\n'
                f'{result.stderr[-4000:]}')
        loaded = json.loads(result.stdout.strip().splitlines()[-1])
        exported_audio = torch.from_numpy(np.load(directory / 'audio.npy'))
        reset_launch_counts(resblock, viterbi)
        with torch.inference_mode():
            eager = export.packed_inference(generator, packed).float()
        torch.cuda.synchronize()
        eager_launches = launch_counts(resblock, viterbi)
        eager_ms = elapsed_ms(torch, lambda: export.packed_inference(
            generator, packed))
        eager = eager.cpu()
        within = within_bf16_bound(torch, exported_audio, eager)
        record = dict(
            phase='export', export_wall_s=export_wall,
            load_wall_s=load_wall, program=loaded,
            eager_launches=eager_launches, eager_ms=eager_ms,
            samples=exported_audio.shape[-1],
            max_abs_err=float((exported_audio - eager).abs().max()),
            within_bf16_bound=within,
            files=sorted(path.name for path in directory.glob('exported*')))
        emit(**record)
        if loaded['launches'] != 12 or eager_launches['resblock'] != 12 or \
                not within or exported_audio.shape != (1, 1, 8192) or \
                record['files'] != ['exported.pt', 'exported.pt2']:
            raise AssertionError('the exported program is wrong')

        rng = np.random.default_rng(17)
        k1_error = check_blocks(torch, rng, resblock, device, [
            (frames, channels, KERNEL_SIZES, ((1, frames),))
            for frames, channels in stage_shapes(config, EXPORT_FRAMES)],
            'export_check')

        # The pack CLI on the main path's features under the cache's names
        prefix = directory / 'cache' / 'utterance'
        prefix.parent.mkdir()
        loudness, pitch, periodicity, ppg = (
            value.float().cpu().numpy() for value in features)
        np.save(f'{prefix}-loudness.npy', loudness)
        np.save(f'{prefix}-viterbi-pitch.npy', pitch)
        np.save(f'{prefix}-viterbi-periodicity.npy', periodicity)
        np.save(f'{prefix}-ppg.npy', ppg)
        start = time.perf_counter()
        result = subprocess.run(
            [sys.executable, '-m', 'promonet_tpu_torch.data.pack',
             '--prefixes', str(prefix), str(prefix), '--output_files',
             str(directory / 'packed-cli.npy'),
             str(directory / 'packed-cli.csv'), '--speaker', '3'],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        pack_wall = time.perf_counter() - start
        if result.returncode:
            raise AssertionError(
                f'the pack CLI exited {result.returncode}:\n'
                f'{result.stderr[-4000:]}')
        expected = port.data.pack.from_features(
            loudness, pitch, periodicity, ppg, speaker=3, config=config)[0]
        written = np.load(directory / 'packed-cli.npy')
        rows = np.loadtxt(
            directory / 'packed-cli.csv', delimiter=',', skiprows=1)
        header = (directory / 'packed-cli.csv').read_text().splitlines()[0]
        record = dict(
            phase='pack', wall_s=pack_wall, shape=list(written.shape),
            npy_equal=bool(np.array_equal(written, expected.numpy())),
            csv_max_abs_err=float(np.abs(
                rows[:, 1:].T - expected.numpy()).max()),
            header_is_labels=header.split(',') == ['time'] + export.labels(
                config))
        emit(**record)
        if not record['npy_equal'] or not record['header_is_labels'] or \
                record['csv_max_abs_err'] > 1e-5 * max(
                    1., float(np.abs(expected.numpy()).max())):
            raise AssertionError('the pack CLI wrote other values')
    return {'program': loaded['launches'], 'eager': eager_launches}, k1_error


def cargan_path(torch, port, device, config, features, generator):
    """Phase 18: CARGAN (the port's HiFi-GAN 512 with the autoregressive
    encoder, seeded) once in bf16 on the main path's features: 12 K1
    calls, finite audio of frames * HOPSIZE samples; half a second of the
    same features through the plain CPU path in float32 with the same
    weights within 5% relative RMS; returns the launch counts"""
    from promonet_tpu_torch.models import cargan
    from promonet_tpu_torch.ops import resblock, viterbi
    loudness, pitch, periodicity, ppg = (
        value if value.dim() == 3 else value[None] for value in features)
    with torch.inference_mode():
        inputs = generator.prepare_features(
            loudness, pitch.reshape(1, -1), periodicity.reshape(1, -1), ppg)
        global_features = generator.prepare_global_features(
            torch.tensor([3], device=device), torch.ones(1, device=device),
            torch.ones(1, device=device))
    model = port.models.init.seeded(cargan.CARGAN(
        inputs.shape[-1], global_features.shape[-1], config), 11)
    reference = cargan.CARGAN(
        inputs.shape[-1], global_features.shape[-1], config)
    reference.load_state_dict(model.state_dict())
    model = model.to(device).eval()
    rng = np.random.default_rng(18)
    previous = torch.from_numpy(
        (0.1 * rng.standard_normal((1, 1, config.CARGAN_INPUT_SIZE))
         ).astype(np.float32)).to(device)

    def forward():
        with torch.inference_mode():
            return model(inputs, global_features, previous, torch.bfloat16)

    audio, seconds, launches = timed_call(torch, forward)
    frames = inputs.shape[1]
    half = int(0.5 * config.SAMPLE_RATE) // config.HOPSIZE
    with torch.inference_mode():
        card = model(inputs[:, :half], global_features, previous,
                     torch.bfloat16).float().cpu()
        cpu = reference(
            inputs[:, :half].float().cpu(), global_features.float().cpu(),
            previous.cpu())
    relative_rms = float(
        (card - cpu).pow(2).mean().sqrt() / cpu.pow(2).mean().sqrt())
    record = dict(
        phase='cargan', frames=frames, seconds=seconds, launches=launches,
        samples=audio.shape[1], finite=bool(torch.isfinite(audio).all()),
        audio_relative_rms_err=relative_rms,
        ms=elapsed_ms(torch, forward, repeats=3, warmup=1))
    emit(**record)
    if launches != {'resblock': 12, 'viterbi': 0, 'viterbi_logfreq': 0} or \
            not record['finite'] or \
            tuple(audio.shape) != (1, frames * config.HOPSIZE, 1) or \
            relative_rms >= 0.05:
        raise AssertionError('CARGAN is wrong on the card')
    return launches


# Phases 19 to 22: the feature extractors trained on the training phase's
# corpus (TRAIN_CORPUS) at the JAX package's batch, window and learning
# rate, the steps cut from its defaults so that the three take about 30 s
EXTRACTOR_STEPS = dict(pitch=1500, ppg=1200, speaker=1200)
EXTRACTOR_DEFAULT_STEPS = dict(pitch=4000, ppg=3000, speaker=4000)
EXTRACTOR_BATCH = dict(
    pitch=dict(batch_size=128, tone_fraction=0.4),
    ppg=dict(batch_size=32, window=256),
    speaker=dict(batch_size=32, window=256))
EXTRACTOR_RATE = dict(pitch=2e-4, ppg=1e-3, speaker=3e-4)
# The short inputs of the reflect padding's repair: one sample, and 300
# and 384, where the padding (384) is not shorter than the input
SHORT_SAMPLES = (1, 300, 384)


def extractor_training_path(torch, port, device, config, directory):
    """Phase 19: `preprocess.{pitch,ppg,speaker}.train` on the card at the
    JAX package's batch and window (EXTRACTOR_BATCH) over the training
    phase's corpus in `directory`, EXTRACTOR_STEPS steps each, every step
    timed by CUDA events; no kernel launches, finite losses, the last
    below the first. Returns the config whose CHECKPOINTS_DIR holds the
    three checkpoints"""
    import contextlib
    from promonet_tpu_torch.ops import resblock, viterbi
    train_config = config.replace(
        CACHE_DIR=Path(directory) / 'cache',
        CHECKPOINTS_DIR=Path(directory) / 'extractors')
    for name, steps in EXTRACTOR_STEPS.items():
        events = []

        def callback(step, loss):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append((event, loss))

        reset_launch_counts(resblock, viterbi)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        start = time.perf_counter()
        # The trainers' progress lines go to stderr
        with contextlib.redirect_stdout(sys.stderr):
            result = getattr(port.preprocess, name).train(
                'synthetic', steps=steps, config=train_config, device=device,
                callback=callback, **EXTRACTOR_BATCH[name])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        step_ms = np.array([
            before.elapsed_time(after)
            for (before, _), (after, _) in zip(events[:-1], events[1:])])
        losses = np.array([float(loss) for _, loss in events])
        median = float(np.median(step_ms))
        figures = dict(zip(('median_cents', 'voicing_accuracy'), result)) \
            if name == 'pitch' else {'accuracy': result}
        record = dict(
            phase='extractor_training', extractor=name, steps=len(events),
            **EXTRACTOR_BATCH[name], learning_rate=EXTRACTOR_RATE[name],
            seconds=seconds, step_ms_median=median,
            step_ms_p10=float(np.percentile(step_ms, 10)),
            step_ms_p90=float(np.percentile(step_ms, 90)),
            steps_per_second=1e3 / median,
            seconds_at_default_steps=median *
            EXTRACTOR_DEFAULT_STEPS[name] / 1e3,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            first_loss=float(losses[0]), last_loss=float(losses[-1]),
            last_100_mean_loss=float(losses[-100:].mean()),
            launches=launch_counts(resblock, viterbi), **figures)
        emit(**record)
        if len(events) != steps or not np.isfinite(losses).all() or \
                losses[-1] >= losses[0] or any(record['launches'].values()):
            raise AssertionError(f'the {name} training is wrong')
    return train_config


def extractor_batch(torch, port, name, config):
    """A batch of the JAX package's size from the training examples of
    extractor `name`, made on the CPU: a tuple of numpy arrays in the
    order of its `training_loss`, and the number of speakers"""
    module = getattr(port.preprocess, name)
    rng = np.random.default_rng(20)
    size = EXTRACTOR_BATCH[name]['batch_size']
    if name == 'pitch':
        frames, bins, voiced, _ = module.training_examples(
            np.random.default_rng(config.RANDOM_SEED), 'synthetic', 120000,
            EXTRACTOR_BATCH[name]['tone_fraction'], config)
        index = rng.choice(np.flatnonzero(voiced), size)
        # As the trainer feeds them: through the bf16 bank
        frames = torch.from_numpy(frames[index]).bfloat16().float().numpy()
        return (frames, bins[index].astype(np.int64)), None
    window = EXTRACTOR_BATCH[name]['window']
    if name == 'ppg':
        mels, labels, masks = module.training_examples(
            'synthetic', window, config, 'cpu')
        index = rng.choice(len(mels), size)
        return (mels[index], labels[index].astype(np.int64),
                masks[index].astype(np.float32)), None
    mels, labels, lengths, speakers = module.training_examples(
        'synthetic', window, config, 'cpu')
    index = rng.choice(len(mels), size)
    return (mels[index], labels[index].astype(np.int64),
            lengths[index].astype(np.int64)), len(speakers)


def extractor_card_vs_cpu(torch, port, device, config):
    """Phase 20: for each extractor, one float32 training step on the card
    and the same step on the CPU, from the same seeded weights on the same
    batch of its training examples: the loss within 1e-4 relative, the
    updated weights within 1e-4 of each leaf's largest magnitude for 99%
    of the elements and within 2 lr + that for every one (Adam moves an
    element whose gradient is within rounding of zero by up to lr either
    way)"""
    import copy
    from promonet_tpu_torch.preprocess import training
    records = {}
    for name in EXTRACTOR_STEPS:
        module = getattr(port.preprocess, name)
        batch, speakers = extractor_batch(torch, port, name, config)
        rate = EXTRACTOR_RATE[name]
        if name == 'pitch':
            model = module.PitchCNN()
        elif name == 'ppg':
            model = module.PPGEncoder(
                config.NUM_MELS, num_phonemes=config.PPG_CHANNELS)
        else:
            model = module.Classifier(
                speakers, config.NUM_MELS, config.WAVLM_EMBEDDING_CHANNELS)
        model = port.models.init.seeded(model, config.RANDOM_SEED)
        losses, weights = [], []
        for where in (torch.device('cpu'), device):
            stepped = copy.deepcopy(model).to(where).train()
            if name == 'speaker':
                optimizer = torch.optim.Adam(
                    stepped.parameters(), lr=rate), None
            else:
                optimizer = training.adamw_cosine(
                    stepped.parameters(), rate,
                    EXTRACTOR_DEFAULT_STEPS[name])
            loss = module.training_loss(stepped, *(
                torch.from_numpy(value).to(where) for value in batch))
            losses.append(float(training.update(loss, *optimizer)))
            weights.append({key: value.detach().cpu()
                            for key, value in stepped.state_dict().items()})
        close, worst = [], 0.
        for key, value in weights[0].items():
            scale = float(value.abs().max())
            error = (weights[1][key] - value).abs()
            close.append((error <= 1e-4 * scale).flatten())
            worst = max(worst, float(error.max()) - 1e-4 * scale)
        records[name] = dict(
            batch=list(batch[0].shape), loss_cpu=losses[0],
            loss_card=losses[1],
            loss_relative_error=abs(losses[1] - losses[0]) / abs(losses[0]),
            share_of_weights_within_bound=float(
                torch.cat(close).float().mean()),
            largest_excess_over_bound=worst, learning_rate=rate)
    emit(phase='extractor_card_vs_cpu', extractors=records)
    for name, record in records.items():
        if record['loss_relative_error'] > 1e-4 or \
                record['share_of_weights_within_bound'] < .99 or \
                record['largest_excess_over_bound'] > \
                2 * record['learning_rate']:
            raise AssertionError(f'a {name} step on the card is wrong')


def trained_extractors_path(torch, port, device, config, audio):
    """Phase 21: the three checkpoints of phase 19 read by `load` and
    `preprocess.from_audio` run on the card with them over the main
    path's audio: one K2 decode, the pitch equal to K2's decode of the
    trained CNN's posteriorgram, whose path equals the plain scan's on
    the card and on the CPU; finite loudness, PPG and speaker embedding.
    Returns the K2 launches of the from_audio call and the largest K2
    state difference of the check"""
    from promonet_tpu_torch.ops import resblock, viterbi
    pitch_module = port.preprocess.pitch
    pitch_model = port.load.pitch_model(config=config, device=device)
    ppg_model = port.load.ppg_model(config=config, device=device)
    encoder = port.load.speaker_encoder(config=config, device=device)
    reset_launch_counts(resblock, viterbi)
    with torch.no_grad():
        loudness, pitch, periodicity, ppg, embedding = \
            port.preprocess.from_audio(
                audio, pitch_model, ppg_model,
                features=('loudness', 'pitch', 'periodicity', 'ppg',
                          'speaker'),
                config=config, device=device, speaker_model=encoder)
        torch.cuda.synchronize()
    launches = launch_counts(resblock, viterbi)
    # The same posteriorgram, decoded by K2 and by the plain scan
    frames = audio.shape[-1] // config.HOPSIZE
    samples = port.data.bucket_frames(
        frames, config.INFERENCE_FRAME_BUCKETS) * config.HOPSIZE
    with torch.no_grad():
        scores = pitch_module.cnn_posteriorgram(
            pitch_model, port.preprocess.core.pad(audio, samples, device),
            config.HOPSIZE)
        refined, _ = pitch_module.decode(
            scores, config.FMIN, config.FMAX, 'viterbi', 'cnn')
    transition = viterbi.triangular_transition(
        scores.shape[-1], pitch_module.TRANSITION_WIDTH).to(device)
    _, initial = pitch_module.decode_constants(
        scores.shape[-1], pitch_module.TRANSITION_WIDTH, str(device))
    largest = check_decodes(
        viterbi, device,
        [('trained_posteriorgram', torch.log_softmax(scores, -1),
          transition)], initial, phase='trained_extractors')
    # The signal's pitch is known: a vibrato around 180 Hz
    truth = harmonic_track(
        audio.shape[-1] / config.SAMPLE_RATE, config.SAMPLE_RATE,
        config.HOPSIZE)[:frames]
    cents = 1200 * np.abs(np.log2(pitch[0].cpu().numpy() / truth))
    record = dict(
        phase='trained_extractors', frames=frames, launches=launches,
        voicing_threshold=pitch_model.voicing_threshold,
        pitch_equal_to_kernel_decode=bool(torch.equal(
            pitch[0], refined[:frames])),
        median_cents_against_the_signal=float(np.median(cents)),
        finite=bool(all(torch.isfinite(value).all() for value in (
            loudness, pitch, periodicity, ppg, embedding))),
        shapes=[list(value.shape) for value in (
            loudness, pitch, periodicity, ppg, embedding)],
        embedding_norm=float(torch.linalg.vector_norm(embedding)))
    emit(**record)
    if launches != {'resblock': 0, 'viterbi': 1, 'viterbi_logfreq': 0} or \
            not record['pitch_equal_to_kernel_decode'] or \
            not record['finite'] or \
            abs(record['embedding_norm'] - 1.) > 1e-5:
        raise AssertionError('the trained extractors are wrong on the card')
    return launches['viterbi'], largest


def from_probabilities_path(torch, port, device, config, audio, encoder):
    """Phase 22: `ops.viterbi.from_probabilities` on (BATCHED_BUCKET, 256)
    probabilities under its default uniform transition, where every
    predecessor ties, and under the pitch decode's: one K2 launch each,
    paths equal to the plain scan's on the card and on the CPU. Then the
    short inputs of the reflect padding's repair (SHORT_SAMPLES) through
    the spectrogram, the loudness and the speaker encoder on the card:
    finite, of the JAX package's shapes (frames = (T + 2 * 384 - NUM_FFT)
    // HOPSIZE + 1, none below 256 samples, where both packages' loudness
    raises on the maximum of no frame). Returns the K2 launches and the
    largest state difference"""
    from promonet_tpu_torch.ops import resblock, viterbi
    rng = np.random.default_rng(22)
    probabilities = torch.softmax(torch.from_numpy(
        3 * rng.standard_normal((BATCHED_BUCKET, 256))).float(), -1)
    states = probabilities.shape[-1]
    launches, largest = 0, 0
    for label, matrix in (
        ('uniform', None),
        ('pitch', torch.exp(viterbi.triangular_transition(states, 9.))),
    ):
        reset_launch_counts(resblock, viterbi)
        kernel = viterbi.from_probabilities(
            probabilities.to(device),
            None if matrix is None else matrix.to(device))
        torch.cuda.synchronize()
        counts = launch_counts(resblock, viterbi)
        plain = viterbi.from_probabilities(probabilities, matrix).numpy()
        dense = torch.full((states, states), 1. / states) \
            if matrix is None else matrix
        on_card_plain = viterbi.backtrace_plain(*viterbi.forward_plain(*(
            torch.log(torch.clamp(value.to(device), min=1e-12))
            for value in (probabilities, dense,
                          torch.full((states,), 1. / states))))
        ).cpu().numpy()
        kernel = kernel.cpu().numpy()
        record = dict(
            phase='from_probabilities', transition=label,
            frames=BATCHED_BUCKET, states=states, launches=counts,
            equal=bool(np.array_equal(kernel, plain) and
                       np.array_equal(kernel, on_card_plain)),
            mismatches=int((kernel != plain).sum()))
        emit(**record)
        launches += counts['viterbi']
        largest = max(largest, int(np.abs(kernel - plain).max()),
                      int(np.abs(kernel - on_card_plain).max()))
        if counts != {'resblock': 0, 'viterbi': 1, 'viterbi_logfreq': 0} or \
                not record['equal']:
            raise AssertionError('from_probabilities is wrong on the card')

    shapes = {}
    for samples in SHORT_SAMPLES:
        short = torch.from_numpy(audio[:, :samples]).to(device)
        padding = (config.NUM_FFT - config.HOPSIZE) // 2
        frames = max(0, (samples + 2 * padding - config.NUM_FFT) //
                     config.HOPSIZE + 1)
        with torch.no_grad():
            outputs = {
                'spectrogram': port.preprocess.spectrogram.from_audio(
                    short, config),
                'mels': port.preprocess.spectrogram.from_audio(
                    short, config, mels=True),
                'speaker': port.preprocess.speaker.encoder_embedding(
                    short, encoder, config, device)}
            if frames:
                outputs['loudness'] = port.preprocess.loudness.from_audio(
                    short, config, bands=None)
        expected = {
            'spectrogram': [config.NUM_FFT // 2 + 1, frames],
            'mels': [config.NUM_MELS, frames],
            'speaker': [config.WAVLM_EMBEDDING_CHANNELS]}
        if frames:
            expected['loudness'] = [config.NUM_FFT // 2 + 1, frames]
        shapes[samples] = {
            name: list(value.shape) for name, value in outputs.items()}
        finite = all(bool(torch.isfinite(value).all())
                     for value in outputs.values())
        if shapes[samples] != expected or not finite or \
                any(value.device.type != 'cuda'
                    for value in outputs.values()):
            emit(phase='short_inputs', samples=samples, shapes=shapes,
                 expected=expected, finite=finite)
            raise AssertionError(f'{samples} samples fail on the card')
    emit(phase='short_inputs', shapes=shapes, finite=True)
    return launches, largest



def shipped_weights_path(torch, port, device, audio):
    """Phase 22b: the checkpoints the repository ships, read on this host
    by the port's own reader (no JAX, no checkpoints_torch/): each one's
    seconds, MB and the zstd decoder's MB/s, its tree held to its SHA-256
    digest; `preprocess.from_audio` with the default (shipped) pitch CNN
    and PPG encoder on the main path's audio (pitch error against the
    signal's known pitch, at most PITCH_THRESHOLD_CENTS) and the shipped
    speaker encoder; then the release generator read by name and from its
    run directory (the same state-dict digest), and the edit chain with
    the latter under runs/promonet/synthetic.py, twice, 12 K1 and 1 K2
    launches a call. Returns the K1 and K2 launches of one edit chain
    (None, None where the release generator is not in the checkout)"""
    from promonet_tpu_torch.ops import resblock, viterbi
    from promonet_tpu_torch.utils import ocdbt, zstd

    start = time.perf_counter()
    zstd.library()
    emit(phase='shipped_weights', zstd_build_seconds=(
        time.perf_counter() - start))
    present = {}
    for relative, digest in SHIPPED_DIGESTS.items():
        path = ROOT / relative
        if not path.exists():
            emit(phase='shipped_weights', checkpoint=relative,
                 release_generator='absent')
            continue
        start = time.perf_counter()
        tree = port.utils.checkpoint.load(path)
        seconds = time.perf_counter() - start
        found = tree_digest(tree)
        # The decoder alone, over the same chunks
        store = ocdbt.open(path)
        chunks = [store[key] for key in store
                  if not key.endswith(b'/.zarray')]
        start = time.perf_counter()
        decoded = sum(len(zstd.decompress(chunk)) for chunk in chunks)
        decode_seconds = time.perf_counter() - start
        emit(phase='shipped_weights', checkpoint=relative, seconds=seconds,
             keys=len(store), chunk_mb=sum(map(len, chunks)) / 1e6,
             decoded_mb=decoded / 1e6, decode_seconds=decode_seconds,
             decoder_mb_per_s=decoded / decode_seconds / 1e6,
             digest_equal=found == digest)
        if found != digest:
            raise AssertionError(f'{relative} decodes to digest {found}')
        present[relative] = path
    if len(present) < 3:
        raise AssertionError('a shipped extractor checkpoint is missing')

    # The default models: nothing of the port's own in CHECKPOINTS_DIR
    (ROOT / 'build').mkdir(exist_ok=True)
    empty = tempfile.TemporaryDirectory(dir=ROOT / 'build')
    config = port.config.load().replace(CHECKPOINTS_DIR=Path(empty.name))
    pitch_model = port.load.pitch_model(config=config, device=device)
    ppg_model = port.load.ppg_model(config=config, device=device)
    encoder = port.load.speaker_encoder(config=config, device=device)
    reset_launch_counts(resblock, viterbi)
    with torch.no_grad():
        loudness, pitch, periodicity, ppg = port.preprocess.from_audio(
            audio, pitch_model, ppg_model, loudness_bands=None,
            config=config, device=device)
        embedding = port.preprocess.speaker.from_audio(
            audio, config=config, device=device)
        torch.cuda.synchronize()
    launches = launch_counts(resblock, viterbi)
    frames = audio.shape[-1] // config.HOPSIZE
    truth = harmonic_track(
        audio.shape[-1] / config.SAMPLE_RATE, config.SAMPLE_RATE,
        config.HOPSIZE)[:frames]
    cents = 1200 * np.abs(np.log2(pitch[0].cpu().numpy() / truth))
    record = dict(
        phase='shipped_weights', path='default_extractors', frames=frames,
        launches=launches, voicing_threshold=pitch_model.voicing_threshold,
        encoder=type(encoder).__name__,
        transcriber=port.preprocess.text.available(config),
        median_cents_against_the_signal=float(np.median(cents)),
        finite=bool(all(torch.isfinite(value).all() for value in (
            loudness, pitch, periodicity, ppg, embedding))),
        embedding_norm=float(torch.linalg.vector_norm(embedding)))
    emit(**record)
    if launches != {'resblock': 0, 'viterbi': 1, 'viterbi_logfreq': 0} or \
            encoder is None or not record['transcriber'] or \
            not record['finite'] or \
            abs(record['embedding_norm'] - 1.) > 1e-5 or \
            not record['median_cents_against_the_signal'] <= \
            PITCH_THRESHOLD_CENTS:
        raise AssertionError('the shipped extractors are wrong on the card')

    release = ROOT / 'runs' / 'promonet' / 'release' / 'generator-00155000'
    if release not in present.values():
        empty.cleanup()
        return None, None
    release_config = port.config.load(ROOT / RELEASE_CONFIG).replace(
        CHECKPOINTS_DIR=Path(empty.name))
    start = time.perf_counter()
    by_name = port.load.generator(release, release_config, device)
    load_seconds = time.perf_counter() - start
    # The run directory resolves to that checkpoint, as the JAX package's
    # `load_params` resolves it; the edit runs from this generator
    start = time.perf_counter()
    generator = port.load.generator(release.parent, release_config, device)
    run_directory_seconds = time.perf_counter() - start
    resolved = port.utils.checkpoint.latest_path(release.parent)
    digests = [state_digest(torch, model.state_dict())
               for model in (by_name, generator)]
    del by_name
    emit(phase='shipped_weights', path='release_run_directory',
         directory=str(release.parent.relative_to(ROOT)),
         resolved=None if resolved is None else resolved.name,
         load_seconds=run_directory_seconds,
         digest_equal=digests[0] == digests[1])
    if resolved != release or digests[0] != digests[1]:
        raise AssertionError(
            f'{release.parent} resolves to {resolved}, not {release}')
    for call in (1, 2):
        reset_launch_counts(resblock, viterbi)
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.no_grad():
            features = port.preprocess.from_audio(
                audio, pitch_model, ppg_model, loudness_bands=None,
                config=release_config, device=device)
            edited = port.edit.from_features(
                *features, config=release_config, **EDIT)
            output = port.synthesize.from_features(
                *edited, generator=generator, speaker=3, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = launch_counts(resblock, viterbi)
    out_frames = edited[1].shape[-1]
    finite = bool(np.isfinite(output).all())
    # The output's pitch, read by the same extractors, against the
    # edited contour it was asked for
    with torch.no_grad():
        _, heard, _, _ = port.preprocess.from_audio(
            output, pitch_model, ppg_model, loudness_bands=None,
            config=release_config, device=device)
    asked = edited[1][0].cpu().numpy()
    heard = heard[0].cpu().numpy()[:len(asked)]
    cents = 1200 * np.abs(np.log2(heard / asked[:len(heard)]))
    emit(phase='shipped_weights', path='release_generator',
         load_seconds=load_seconds, speakers=release_config.NUM_SPEAKERS,
         ms=seconds * 1e3, launches=launches, output_frames=out_frames,
         samples=output.shape[-1], finite=finite,
         median_cents_against_the_edit=float(np.median(cents)))
    empty.cleanup()
    if not finite or output.shape != (1, out_frames * config.HOPSIZE):
        raise AssertionError('the release generator\'s output is wrong')
    if launches != {'resblock': 12, 'viterbi': 1, 'viterbi_logfreq': 0}:
        raise AssertionError(f'release generator launches {launches}')
    return launches['resblock'], launches['viterbi']


# Phase 22c: run.sh's dataset chain through the port's command lines, on
# trees laid out as the published datasets are (under DATA_DIR, as a user
# extracts them), made from a seed. LibriTTS, 24 kHz, is the chain's
# corpus: the ten held-out speakers of the recomputed partition and 14
# others, each with `long` utterances inside the test window of 4 to 10 s
# and `short` ones of 1.5 to 3 s. DAPS (44.1 kHz, one speaker's takes
# quiet enough to be gained up) and VCTK (48 kHz, both microphones, one
# utterance without a transcript) are formatted only.
PIPELINE_TREES = dict(
    libritts=dict(rate=24000, others=14, long=2, long_seconds=4.5,
                  short=10, short_seconds=(1.5, 3.)),
    daps=dict(rate=44100, scripts=2, seconds=1., quiet_peak=0.1),
    vctk=dict(rate=48000, speakers=4, utterances=3, seconds=1.))
# Settings of the chain's configuration file besides its directories: the
# default configuration at full width, cut to two training steps, with
# the chain's corpus as TRAINING_DATASET (so the generator's pitch bins
# are computed from the chain's cache; 1230 speakers, LibriTTS's)
PIPELINE_SETTINGS = {'STEPS': 2, 'TRAINING_DATASET': 'libritts'}
# (stage, arguments, seconds its process may take), in run.sh's order
PIPELINE_STEPS = (
    ('data.download', ['--datasets', 'daps', 'libritts', 'vctk'], 180),
    ('data.augment', ['--datasets', 'libritts'], 180),
    ('data.preprocess', ['--datasets', 'libritts'], 420),
    ('partition', ['--datasets', 'libritts'], 90),
    ('train', ['--dataset', 'libritts'], 420),
    ('evaluate', ['--datasets', 'libritts'], 420))


def pipeline_trees(port, data, rng):
    """Write the LibriTTS, DAPS and VCTK trees under `data`; returns the
    LibriTTS speaker IDs and the quiet DAPS speaker"""
    save = port.utils.audio.save

    def utterance(path, seconds, rate, base, peak=0.5):
        path.parent.mkdir(parents=True, exist_ok=True)
        save(path, harmonic_audio(seconds, rate, base) * (peak / 0.5), rate)

    tree = PIPELINE_TREES['libritts']
    held_out = port.partition.core.ADAPTATION_SPEAKERS['libritts']
    others = [str(speaker) for speaker in rng.choice(
        [s for s in range(14, 9000) if str(s) not in held_out],
        tree['others'], replace=False)]
    root = data / 'libritts' / 'train-clean-100'
    for speaker in held_out + others:
        chapter = str(rng.integers(1000, 99999))
        base = rng.uniform(100., 250.)
        seconds = [tree['long_seconds']] * tree['long'] + list(rng.uniform(
            *tree['short_seconds'], tree['short']))
        for index, length in enumerate(seconds):
            name = f'{speaker}_{chapter}_{index + 1:06d}_000000'
            folder = root / speaker / chapter
            utterance(folder / f'{name}.wav', length, tree['rate'], base)
            (folder / f'{name}.normalized.txt').write_text(
                f'utterance {index + 1} of reader {speaker}')

    tree = PIPELINE_TREES['daps']
    speakers = [f'{sex}{k}' for sex in 'fm' for k in range(1, 11)]
    quiet = speakers[rng.integers(len(speakers))]
    for speaker in speakers:
        base = rng.uniform(100., 250.)
        for script in range(1, tree['scripts'] + 1):
            name = f'{speaker}_script{script}_clean'
            utterance(
                data / 'daps' / 'clean' / f'{name}.wav', tree['seconds'],
                tree['rate'], base,
                tree['quiet_peak'] if speaker == quiet else 0.5)
            (data / 'daps' / 'clean' / f'{name}.txt').write_text(
                f'script {script} read by {speaker}')

    tree = PIPELINE_TREES['vctk']
    for index in range(tree['speakers']):
        speaker = f'p{225 + index}'
        base = rng.uniform(100., 250.)
        for number in range(1, tree['utterances'] + 1):
            stem = f'{speaker}_{number:03d}'
            for mic in (1, 2):
                utterance(
                    data / 'vctk' / 'wav48_silence_trimmed' / speaker /
                    f'{stem}_mic{mic}.wav', tree['seconds'], tree['rate'],
                    base)
            # The last speaker's second utterance has no transcript
            if (index, number) != (tree['speakers'] - 1, 2):
                text = data / 'vctk' / 'txt' / speaker / f'{stem}.txt'
                text.parent.mkdir(parents=True, exist_ok=True)
                text.write_text(f'utterance {number} of {speaker}')
    return held_out + others, quiet


def wav_seconds(port, files):
    """(count, seconds) of wav files, from their headers"""
    files = list(files)
    return len(files), sum(map(port.utils.audio.duration, files))


def dataset_pipeline_path(torch, port, device, smi, tf32_defaults):
    """Phase 22c: `run.sh`'s dataset chain (download, augment, preprocess,
    partition, train, evaluate), each step a command line of the port in a
    process of its own on the card, from trees in the published datasets'
    layouts to a trained checkpoint's evaluation; each step's output
    checked, the preprocess CLI's files against in-process calls with the
    same shipped extractors (1 K2 each), the pitch bins the train CLI
    computed against a recomputation, the notifications of the five
    notified steps, and one edit from the trained checkpoint (12 K1, 1
    K2). Returns the K1 and K2 launches of this
    process's calls: the three checks and the edit"""
    from promonet_tpu_torch.ops import resblock, viterbi
    device = torch.device(device)
    gpu = str(device.index or 0) if device.type == 'cuda' else '-1'
    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as directory:
        directory = Path(directory)
        data = directory / 'datasets'
        start = time.perf_counter()
        speakers, quiet = pipeline_trees(
            port, data, np.random.default_rng(15))
        emit(phase='dataset_pipeline', trees=PIPELINE_TREES,
             trees_seconds=time.perf_counter() - start)
        # An empty CHECKPOINTS_DIR: the extractors are the shipped ones
        (directory / 'checkpoints').mkdir()
        dirs = dict(
            DATA_DIR=data, CACHE_DIR=directory / 'cache',
            PARTITIONS_DIR=directory / 'partitions',
            AUGMENT_DIR=directory / 'augmentations',
            RUNS_DIR=directory / 'runs', EVAL_DIR=directory / 'eval',
            RESULTS_DIR=directory / 'results',
            CHECKPOINTS_DIR=directory / 'checkpoints')
        config_file = directory / 'dataset_pipeline.py'
        config_file.write_text('\n'.join(
            ["MODULE = 'promonet_tpu_torch'"] +
            [f'{name} = {str(value)!r}' for name, value in dirs.items()] +
            [f'{name} = {value!r}'
             for name, value in PIPELINE_SETTINGS.items()]) + '\n')
        config = port.config.load(config_file)
        cache = config.CACHE_DIR / 'libritts'
        checkpoint = config.RUNS_DIR / config.CONFIG / \
            f'generator-{config.STEPS:08d}.pt'
        steps = iter(enumerate(PIPELINE_STEPS, 1))
        no_launch = {'resblock': 0, 'viterbi': 0, 'viterbi_logfreq': 0}

        def run(*extra):
            """The next step's command line in a process of its own; its
            line so far: wall seconds (the process start included), the
            import and main seconds and the process's launch counts"""
            number, (stage, arguments, timeout) = next(steps)
            arguments = [*arguments, *extra, '--config', str(config_file),
                         '--gpu', gpu]
            start = time.perf_counter()
            result = subprocess.run(
                [sys.executable, '-c', CLI_RUNNER, stage, *arguments],
                cwd=ROOT, capture_output=True, text=True, timeout=timeout)
            wall = time.perf_counter() - start
            if result.returncode:
                raise AssertionError(
                    f'python -m promonet_tpu_torch.{stage} exited '
                    f'{result.returncode}:\n{result.stderr[-4000:]}')
            return dict(
                phase='dataset_pipeline', step=number, command=' '.join([
                    'python -m', f'promonet_tpu_torch.{stage}', *arguments
                ]).replace(str(directory), '<build>'),
                wall_s=wall, **json.loads(result.stdout.splitlines()[-1]),
                nvidia_smi=smi)

        # 1. Format the three trees into the cache
        record = run()
        record['wavs'], record['audio_seconds'] = wav_seconds(
            port, data.rglob('*.wav'))

        def files(folder):
            return {
                'speakers': len([d for d in folder.iterdir() if d.is_dir()]),
                '-100.wav': len(list(folder.glob('*/*-100.wav'))),
                'own rate .wav': len([
                    wav for wav in folder.glob('*/*.wav')
                    if not wav.stem.endswith('-100')]),
                '.txt': len(list(folder.glob('*/*.txt')))}

        layout = {name: files(config.CACHE_DIR / name)
                  for name in ('libritts', 'daps', 'vctk')}
        tree = PIPELINE_TREES['libritts']
        utterances = len(speakers) * (tree['long'] + tree['short'])
        # Speaker indices in order of first appearance over the sorted
        # paths ('1355' sorts before '196')
        order = list(dict.fromkeys(
            wav.name.split('_')[0]
            for wav in sorted((data / 'libritts').rglob('*.wav'))))
        speaker_map = json.loads((cache / 'speakers.json').read_text())
        daps_order = list(dict.fromkeys(
            wav.name.split('_')[0]
            for wav in sorted(path.resolve()
                              for path in (data / 'daps').rglob('*.wav'))))
        quiet_dir = config.CACHE_DIR / 'daps' / \
            f'{daps_order.index(quiet):04d}'
        peaks = [float(np.abs(port.utils.audio.load(wav)[0]).max())
                 for wav in sorted(quiet_dir.glob('*.wav'))]
        vctk = config.CACHE_DIR / 'vctk'
        correspondence = json.loads(
            (vctk / 'correspondence.json').read_text())
        vctk_rates = {port.utils.audio.load(wav)[1]
                      for wav in vctk.glob('*/*-100.wav')}
        record.update(
            layout=layout, speakers_json_in_order=speaker_map == {
                speaker: [order.index(speaker), tree['long'] + tree['short']]
                for speaker in order},
            speakers_mapped=len(speaker_map), quiet_speaker=quiet,
            quiet_peaks=peaks, vctk_takes=len(correspondence),
            vctk_rates=sorted(vctk_rates))
        emit(**record)
        vctk_tree = PIPELINE_TREES['vctk']
        takes = vctk_tree['speakers'] * vctk_tree['utterances'] * 2
        if layout['libritts'] != {
                'speakers': len(speakers), '-100.wav': utterances,
                'own rate .wav': utterances, '.txt': utterances} or \
                not record['speakers_json_in_order'] or \
                len(speaker_map) != len(speakers) or \
                layout['daps']['speakers'] != 20 or \
                not all(abs(peak - 0.35) <= 0.01 for peak in peaks) or \
                len(peaks) != 2 * PIPELINE_TREES['daps']['scripts'] or \
                layout['vctk']['-100.wav'] != takes - 2 or \
                len(correspondence) != takes - 2 or \
                not {'p225_001_mic1', 'p225_001_mic2'} <= set(
                    correspondence.values()) or \
                vctk_rates != {config.SAMPLE_RATE} or \
                record['launches'] != no_launch:
            raise AssertionError('the formatted caches are wrong')

        # 2. Augment: a pitch-shifted and a loudness-scaled copy of each
        record = run()
        copies = sorted(
            wav for wav in cache.glob('*/*.wav') if '-100-' in wav.stem)
        record['wavs'], record['audio_seconds'] = wav_seconds(port, copies)
        emit(**record)
        if record['wavs'] != 2 * utterances or \
                record['launches'] != no_launch:
            raise AssertionError('the augmentation is wrong')

        # 3. Preprocess every cached wav on the card: one K2 decode each
        record = run()
        wavs = sorted(cache.glob('*/*.wav'))
        record['wavs'], record['audio_seconds'] = wav_seconds(port, wavs)
        infix = '-viterbi' if config.VITERBI_DECODE_PITCH else ''
        suffixes = {
            'loudness': '-loudness', 'pitch': f'{infix}-pitch',
            'periodicity': f'{infix}-periodicity',
            'spectrogram': '-spectrogram', 'ppg': '-ppg'}
        features = port.data.preprocess.core.FEATURES
        missing = [
            f'{wav.stem}{suffixes[name]}.npy' for wav in wavs
            for name in features
            if not (wav.parent / f'{wav.stem}{suffixes[name]}.npy').exists()]
        record.update(missing_feature_files=len(missing))
        emit(**record)
        if missing or record['launches'] != dict(no_launch, viterbi=len(
                wavs)):
            raise AssertionError(f'the preprocessing is wrong: {missing[:4]}')

        # The CLI's files of three wavs (a long and a short original and a
        # copy) against the same features from in-process calls with the
        # same shipped extractors, each one K2 decode, with PyTorch's
        # default TF32 settings as the CLI process had them
        pitch_model = port.load.pitch_model(config=config, device=device)
        ppg_model = port.load.ppg_model(config=config, device=device)
        chosen = [cache / '0000' / '000000-100.wav',
                  cache / '0000' / f'{tree["long"]:06d}-100.wav', copies[0]]
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32_defaults
        differences, k2_launches = {}, []
        try:
            for wav in chosen:
                reset_launch_counts(resblock, viterbi)
                with torch.no_grad():
                    values = port.preprocess.from_file(
                        wav, pitch_model, ppg_model, features,
                        loudness_bands=None, config=config, device=device)
                k2_launches.append(launch_counts(resblock, viterbi))
                for name, value in zip(features, values):
                    file = f'{wav.stem}{suffixes[name]}.npy'
                    ours = value.cpu().numpy()
                    theirs = np.load(wav.parent / file)
                    differences[f'{wav.parent.name}/{file}'] = (
                        float(np.abs(ours - theirs).max())
                        if ours.shape == theirs.shape else float('inf'),
                        max(1., float(np.abs(ours).max())))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        decoded_equal = all(
            difference == 0 for name, (difference, _) in differences.items()
            if 'pitch' in name or 'periodicity' in name)
        within = all(difference <= 1e-5 * scale
                     for difference, scale in differences.values())
        emit(phase='dataset_pipeline', check='preprocess_against_in_process',
             wavs=[f'{wav.parent.name}/{wav.name}' for wav in chosen],
             max_abs_difference={
                 name: difference
                 for name, (difference, _) in differences.items()},
             decoded_equal=decoded_equal, within_tolerance=within,
             launches=k2_launches)
        if not decoded_equal or not within or any(
                counts != dict(no_launch, viterbi=1)
                for counts in k2_launches):
            raise AssertionError('the preprocess CLI and the in-process '
                                 'calls disagree')

        # 4. Partition, recomputed through speakers.json
        record = run()
        partition = port.load.partition('libritts', False, config)
        stems = [stem for split in partition.values() for stem in split]
        record['wavs'], record['audio_seconds'] = wav_seconds(
            port, (cache / f'{stem}.wav' for stem in stems))
        held_out = {
            f'{speaker_map[speaker][0]:04d}'
            for speaker in port.partition.core.ADAPTATION_SPEAKERS[
                'libritts']}
        record.update(splits={
            name: len(split) for name, split in partition.items()})
        emit(**record)
        if sorted(partition) != ['test', 'train', 'valid'] or \
                len(partition['test']) != tree['long'] * len(held_out) or \
                {stem.split('/')[0] for stem in partition['test']} != \
                held_out or len(stems) != len(set(stems)) or \
                len(partition['train']) < config.BATCH_SIZE or \
                record['launches'] != no_launch:
            raise AssertionError(f'the partition is wrong: {record["splits"]}')

        # 5. Train: STEPS steps and the validation at step 0 (one
        # generator call of 12 K1 and one K2 decode per item)
        record = run()
        train_data = port.data.Dataset('libritts', 'train', config)
        record['wavs'], record['audio_seconds'] = wav_seconds(
            port, (cache / f'{stem}.wav' for stem in train_data.stems))
        record['trained_audio_seconds'] = \
            config.STEPS * config.BATCH_SIZE * config.CHUNK_SIZE / \
            config.SAMPLE_RATE
        metrics = [json.loads(line) for line in (
            checkpoint.parent / 'metrics.jsonl').read_text().splitlines()]
        validation = {
            name: value for line in metrics for name, value in line.items()
            if name.startswith('validation/')}
        items = min(config.DEFAULT_EVALUATION_STEPS, len(partition['valid']))
        record.update(checkpoint=checkpoint.name, validation=validation)
        emit(**record)
        if not checkpoint.exists() or not validation or not all(
                np.isfinite(value) for value in validation.values()) or \
                record['launches'] != dict(
                    no_launch, resblock=12 * items, viterbi=items):
            raise AssertionError('the training run is wrong')

        # The variable pitch bins the train CLI's generator computed over
        # the train partition's cached pitch and cached beside the cache,
        # against the same quantiles recomputed here
        bins_files = sorted((config.CACHE_DIR.parent / 'stats').glob(
            f'libritts-{config.PITCH_BINS}*.npy'))
        if len(bins_files) != 1:
            raise AssertionError(f'pitch-bin statistics: {bins_files}')
        bins_file = bins_files[0]
        bins = np.load(bins_file)
        voiced = []
        for stem in train_data.stems:
            pitch = np.load(cache / f'{stem}{infix}-pitch.npy')
            periodicity = np.load(cache / f'{stem}{infix}-periodicity.npy')
            voiced.append(pitch[
                ~np.isnan(pitch) & (periodicity > config.VOICING_THRESHOLD)])
        voiced = np.sort(np.concatenate(voiced))
        expected = voiced[np.linspace(
            len(voiced) / config.PITCH_BINS, len(voiced) - 1,
            config.PITCH_BINS).astype(np.int64)].astype(np.float32)
        log_uniform = np.exp(np.linspace(
            np.log(config.FMIN), np.log(config.FMAX),
            config.PITCH_BINS)).astype(np.float32)
        bins_bytes = bins_file.read_bytes()
        record = dict(
            phase='dataset_pipeline', check='pitch_bins',
            file=str(bins_file.relative_to(directory)),
            voiced_frames=len(voiced), bins=len(bins),
            dtype=str(bins.dtype), lowest_hz=float(bins[0]),
            median_hz=float(bins[len(bins) // 2]), highest_hz=float(bins[-1]),
            equal_to_recomputation=bool(
                bins.dtype == expected.dtype and
                np.array_equal(bins, expected)),
            strictly_increasing=bool(np.all(np.diff(bins) > 0)),
            log_uniform=bool(np.array_equal(bins, log_uniform)))
        emit(**record)
        if not record['equal_to_recomputation'] or \
                not record['strictly_increasing'] or record['log_uniform']:
            raise AssertionError('the computed pitch bins are wrong')

        # 6. Evaluate the step-STEPS generator over the test partition
        record = run('--checkpoint', str(checkpoint))
        test = partition['test']
        record['wavs'], record['audio_seconds'] = wav_seconds(
            port, (cache / f'{stem}.wav' for stem in test))
        results = json.loads((
            config.RESULTS_DIR / config.CONFIG / 'libritts' / 'results.json'
        ).read_text())
        objective = results['objective']
        conditions = 1 + 5 * len(config.EVALUATION_RATIOS)
        finite = all(
            np.isfinite(values[name]).all() for values in objective.values()
            for name in ('periodicity', 'ppg')) and all(
            np.isfinite(value) for values in objective.values()
            for value in values['loudness'].values())
        launches = record['launches']
        record.update(
            jobs=len(test) * conditions, conditions=sorted(objective),
            finite=finite, objective_reconstructed=objective['reconstructed'],
            benchmark=results['benchmark'])
        emit(**record)
        if len(objective) != conditions or not finite or \
                launches['viterbi'] < record['jobs'] or \
                not launches['resblock'] or launches['resblock'] % 12 or \
                launches['viterbi_logfreq']:
            raise AssertionError('the evaluation is wrong')

        # The evaluate CLI's generator read the bins and left them, and
        # each step but the partition reported its start and end
        statuses = notifications(config.RUNS_DIR)
        record = dict(
            phase='dataset_pipeline', check='bins_and_notifications',
            bins_unchanged=bins_file.read_bytes() == bins_bytes,
            notifications=statuses)
        emit(**record)
        if not record['bins_unchanged'] or statuses != [
                [job, status]
                for job in ('download', 'augment', 'preprocess', 'train',
                            'evaluate')
                for status in ('started', 'completed')]:
            raise AssertionError('the bins moved or a step was not notified')

        # One test stem edited with the trained generator in this process
        stem = test[0]
        generator = port.load.generator(checkpoint, config, device)
        speaker = port.data.Dataset('libritts', 'test', config).speaker_index[
            stem.split('/')[0]]
        audio = port.load.audio(cache / f'{stem}.wav', config)
        reset_launch_counts(resblock, viterbi)
        with torch.no_grad():
            features = port.preprocess.from_audio(
                audio, pitch_model, ppg_model, loudness_bands=None,
                config=config, device=device)
            edited = port.edit.from_features(*features, config=config, **EDIT)
            output = port.synthesize.from_features(
                *edited, generator=generator, speaker=speaker, device=device)
        launches = launch_counts(resblock, viterbi)
        samples = edited[1].shape[-1] * config.HOPSIZE
        finite = bool(np.isfinite(output).all())
        emit(phase='dataset_pipeline', check='edit_from_trained_checkpoint',
             stem=stem, speaker=speaker, launches=launches,
             samples=output.shape[-1], finite=finite)
        if launches != dict(no_launch, resblock=12, viterbi=1) or \
                not finite or output.shape != (1, samples):
            raise AssertionError('the trained checkpoint\'s edit is wrong')
    return {'resblock': launches['resblock'],
            'viterbi': launches['viterbi'] + len(k2_launches)}


def main():
    try:
        import torch
    except ImportError:
        print('chip_smoke: PyTorch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False); nothing was run', file=sys.stderr)
        return 1
    if not (ROOT / 'promonet_tpu_torch' / 'csrc').is_dir():
        print('chip_smoke: run from a checkout of the repository '
              '(promonet_tpu_torch/ not found)', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import promonet_tpu_torch as port
    from promonet_tpu_torch.ops import _build, resblock, viterbi

    # PyTorch's own settings, which the CLI processes of phase 13 run with
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0] if smi else 'nvidia-smi: no output'
    emit(phase='device', name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. Build
    start = time.perf_counter()
    reports = _build.build(
        ['resblock', 'viterbi', 'viterbi_logfreq', 'fargan_subframe'])
    emit(phase='build', seconds=time.perf_counter() - start,
         ptxas={
             kernel: [line.strip() for line in report.splitlines()
                      if 'registers' in line or 'spill' in line
                      or 'warning' in line.lower()]
             for kernel, report in reports.items()})

    config = port.config.load()
    rng = np.random.default_rng(0)

    # 3. Kernels against their plain versions
    bucket_in = port.data.bucket_frames(
        int(10 * config.SAMPLE_RATE) // config.HOPSIZE,
        config.INFERENCE_FRAME_BUCKETS)
    bucket_out = port.data.bucket_frames(
        round(int(10 * config.SAMPLE_RATE) // config.HOPSIZE * 1.4),
        config.INFERENCE_FRAME_BUCKETS)
    # At the main path's synthesis bucket
    shapes = stage_shapes(config, bucket_out)
    # (frames, channels, kernel sizes, (batch, length) pairs): the main
    # path's shapes with ragged batches, the batched path's at batch 8,
    # one streaming window's, then an odd width
    k1_checks = [
        (frames, channels, KERNEL_SIZES,
         ((1, frames), (4, frames // 16 + 37)))
        for frames, channels in shapes]
    k1_checks += [
        (frames, channels, KERNEL_SIZES, ((8, frames),))
        for frames, channels in stage_shapes(config, BATCHED_BUCKET)]
    k1_checks += [
        (frames, channels, KERNEL_SIZES, ((1, frames),))
        for frames, channels in stage_shapes(config, STREAM_WINDOW)]
    k1_checks.append((1000, 48, (7,), ((2, 1000),)))
    # The fused pair keeps 128 - (k - 1) rows per thread block at 128
    # channels: a length below one block, one that ends three rows into
    # the second block (inside the first one's recomputed halo), and one
    # shorter than the halo itself
    k1_checks.append((70, 128, (11,), ((2, 70), (2, 121))))
    k1_checks.append((5, 64, (11,), ((3, 5),)))
    k1_error = check_blocks(torch, rng, resblock, device, k1_checks)

    transition = viterbi.triangular_transition(256, 9.).to(device)
    initial = torch.full(
        (256,), -float(np.log(np.float32(256))), device=device)
    def random_observation(frames):
        return torch.log_softmax(torch.from_numpy(
            3 * rng.standard_normal((frames, 256))).float(), -1)

    masked = random_observation(bucket_in)
    masked[torch.from_numpy(rng.random((bucket_in, 256)) < 0.5)] = \
        -float('inf')
    masked[bucket_in // 3] = -float('inf')
    nan_frame = random_observation(bucket_in)
    nan_frame[bucket_in // 2] = float('nan')
    ties = torch.from_numpy(np.round(
        rng.standard_normal((bucket_in, 256)))).float()
    all_equal = torch.zeros(256, 256, device=device)
    random_dense = torch.from_numpy(
        rng.standard_normal((256, 256))).float().to(device)
    observations = {'random': random_observation(bucket_in)}
    # (label, observation, transition)
    k2_checks = [
        ('random', observations['random'], transition),
        ('ties', ties, transition),
        ('one_frame', torch.zeros(1, 256), transition),
        ('two_frames', random_observation(2), transition),
        ('4096_frames', random_observation(4096), transition),
        ('minus_inf', masked, transition),
        ('nan_frame', nan_frame, transition),
        ('all_equal_transition', ties[:300], all_equal),
        ('random_dense_transition', random_observation(100), random_dense),
        ('batch_of_3', torch.stack([
            random_observation(bucket_in), ties, nan_frame]), transition)]
    k2_error = check_decodes(viterbi, device, k2_checks, initial)

    # K3 on the harmonics path's frequency axis, against the plain scan
    # over the dense transition on the card (and on the CPU where small)
    _, stft_axis = port.preprocess.harmonics.stft_features(
        np.zeros((1, 4 * config.HOPSIZE), np.float32), config=config,
        device=device)
    frames_10s = int(10 * config.SAMPLE_RATE) // config.HOPSIZE
    full = logfreq_observations(torch, rng, frames_10s, stft_axis)
    small_axis = np.linspace(50., 8000., 200)
    long_axis = np.linspace(50., 8000., 3000)
    # (label, observation, axis, route override)
    k3_checks = [
        (label, observation, stft_axis, None)
        for label, observation in full.items()]
    k3_checks += [
        ('batch_of_2', torch.stack([full['random'], full['nan_frame']]),
         stft_axis, None),
        ('two_frames', full['random'][:2], stft_axis, None),
        ('grid_route', full['masked'][:120], stft_axis, 'grid'),
        ('small', logfreq_observations(
            torch, rng, 70, small_axis)['random'], small_axis, None),
        ('one_frame', logfreq_observations(
            torch, rng, 1, small_axis)['random'], small_axis, None),
        ('long_axis', logfreq_observations(
            torch, rng, 40, long_axis)['masked'], long_axis, None)]
    k3_observation = full['random'].to(device)
    k3_route = viterbi.logfreq_route(stft_axis, device)
    k3_routes = {
        'stft': k3_route,
        'small': viterbi.logfreq_route(small_axis, device),
        'long': viterbi.logfreq_route(long_axis, device)}
    emit(phase='check', kernel='viterbi_logfreq', routes=k3_routes)
    if k3_route[0] != 'cluster' or k3_routes['small'] != ('cluster', 1) \
            or k3_routes['long'][0] != 'grid':
        raise AssertionError(f'viterbi_logfreq routes {k3_routes}')
    k3_error = 0
    for label, observation, axis, route in k3_checks:
        states = len(axis)
        log_initial = torch.log_softmax(
            torch.linspace(0., -7., states), -1).to(device)
        dense = viterbi.logfreq_transition_dense(axis).to(device)
        batch = observation if observation.dim() == 3 else observation[None]
        on_card_plain = np.stack([
            viterbi.backtrace_plain(*viterbi.forward_plain(
                sequence.to(device), dense, log_initial)).cpu().numpy()
            for sequence in batch])
        routes_before = dict(viterbi.decode_logfreq.routes)
        if route is None:
            kernel = viterbi.decode_logfreq(
                observation.to(device), axis, log_initial)
        else:
            kernel = viterbi._decode_logfreq_cuda(
                observation.to(device), axis, log_initial, 3.5, route=route)
        torch.cuda.synchronize()
        taken = [name for name, count in viterbi.decode_logfreq.routes.items()
                 if count > routes_before[name]]
        kernel = kernel.cpu().numpy().reshape(on_card_plain.shape)
        equal = bool(np.array_equal(kernel, on_card_plain))
        if label == 'batch_of_2':
            singles = np.stack([
                viterbi.decode_logfreq(
                    sequence.to(device), axis, log_initial).cpu().numpy()
                for sequence in batch])
            equal = equal and bool(np.array_equal(kernel, singles))
        if states == 200:
            plain = viterbi.decode_logfreq(
                observation, axis, log_initial.cpu()).numpy()
            equal = equal and bool(np.array_equal(kernel[0], plain))
        emit(phase='check', kernel='viterbi_logfreq', observation=label,
             frames=observation.shape[-2], states=states, route=taken,
             equal=equal, mismatches=int((kernel != on_card_plain).sum()))
        k3_error = max(k3_error, int(np.abs(kernel - on_card_plain).max()))
        if not equal:
            raise AssertionError('viterbi_logfreq kernel disagrees')
    del dense

    # 4. Main path at full width
    pitch_model = port.models.init.seeded(
        port.preprocess.PitchCNN(), 1).to(device).eval()
    ppg_model = port.models.init.seeded(
        port.preprocess.PPGEncoder(), 2).to(device).eval()
    generator = port.models.init.seeded(
        port.models.Generator(config), 3).to(device).eval()
    audio = harmonic_audio(10., config.SAMPLE_RATE)

    def chain(audio, device=device, pitch_model=pitch_model,
              ppg_model=ppg_model, generator=generator, config=config):
        features = port.preprocess.from_audio(
            audio, pitch_model, ppg_model, loudness_bands=None,
            config=config, device=device)
        edited = port.edit.from_features(*features, config=config, **EDIT)
        output = port.synthesize.from_features(
            *edited, generator=generator, speaker=3, device=device)
        return features, edited, output

    launches = {}
    for call in (1, 2):
        resblock.fused_block.launches = 0
        viterbi.decode.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        features, edited, output = chain(audio)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {'resblock': resblock.fused_block.launches,
                    'viterbi': viterbi.decode.launches}
        frames = edited[1].shape[-1]
        finite = bool(np.isfinite(output).all())
        emit(phase='main_path', call=call, seconds=seconds,
             audio_seconds=audio.shape[-1] / config.SAMPLE_RATE,
             realtime_factor=audio.shape[-1] / config.SAMPLE_RATE / seconds,
             input_frames=features[1].shape[-1], output_frames=frames,
             samples=output.shape[-1], finite=finite, launches=launches,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        if not finite or output.shape != (1, frames * config.HOPSIZE):
            raise AssertionError('main path output is wrong')
        if launches != {'resblock': 12, 'viterbi': 1}:
            raise AssertionError(f'main path launches {launches}')
    edited_main = edited

    # Per-stage device time of the main path (second call's inputs)
    stage_ms = {
        'preprocess': elapsed_ms(torch, lambda: port.preprocess.from_audio(
            audio, pitch_model, ppg_model, loudness_bands=None,
            config=config, device=device), repeats=3, warmup=1),
        'edit': elapsed_ms(torch, lambda: port.edit.from_features(
            *features, config=config, **EDIT), repeats=3, warmup=1),
        'synthesize': elapsed_ms(torch, lambda: port.synthesize.from_features(
            *edited, generator=generator, speaker=3, device=device),
            repeats=3, warmup=1)}
    emit(phase='main_path_stages', ms=stage_ms)

    # 5. Reference: a small input through the plain CPU path in float32
    # with the same weights. Loudness and PPG do not depend on the decoded
    # pitch path and must agree; pitch and periodicity are reported as the
    # share of frames that agree (random weights leave the Viterbi scores
    # nearly flat, so a float32 sum order can move the path). Both
    # generators then synthesize the CPU's edited features, so the audio
    # comparison sees the generator alone.
    small = harmonic_audio(0.5, config.SAMPLE_RATE)
    cpu32 = config.replace(PRECISION='float32')
    reference_generator = port.models.Generator(cpu32)
    reference_generator.load_state_dict(
        {k: v.cpu() for k, v in generator.state_dict().items()})
    ours = [x.cpu() for x in port.preprocess.from_audio(
        small, pitch_model, ppg_model, loudness_bands=None, config=config,
        device=device)]
    pitch_cpu = port.models.init.seeded(port.preprocess.PitchCNN(), 1)
    ppg_cpu = port.models.init.seeded(port.preprocess.PPGEncoder(), 2)
    theirs = port.preprocess.from_audio(
        small, pitch_cpu, ppg_cpu, loudness_bands=None, config=cpu32,
        device='cpu')
    edited = port.edit.from_features(*theirs, config=cpu32, **EDIT)
    audio_card = port.synthesize.from_features(
        *[x.to(device) for x in edited], generator=generator, speaker=3,
        device=device)
    audio_cpu = port.synthesize.from_features(
        *edited, generator=reference_generator, speaker=3, device='cpu')
    cents = 1200 * torch.abs(torch.log2(ours[1] / theirs[1]))
    relative_rms = float(
        np.sqrt(np.mean((audio_card - audio_cpu) ** 2) /
                np.mean(audio_cpu ** 2)))
    record = dict(
        phase='reference',
        loudness_max_abs_db=float((ours[0] - theirs[0]).abs().max()),
        ppg_max_abs=float((ours[3] - theirs[3]).abs().max()),
        pitch_share_within_1_cent=float((cents < 1).float().mean()),
        periodicity_share_within_0_001=float(
            ((ours[2] - theirs[2]).abs() < 1e-3).float().mean()),
        audio_relative_rms_err=relative_rms)
    record['agree'] = (
        audio_card.shape == audio_cpu.shape and
        bool(np.isfinite(audio_card).all()) and relative_rms < 0.05 and
        record['loudness_max_abs_db'] < 0.05 and record['ppg_max_abs'] < 1e-3)
    emit(**record)
    if not record['agree']:
        raise AssertionError('card and CPU reference disagree')

    # 6. Second path: harmonic contours, then audio in → edited audio out
    all_features = port.preprocess.core.DEFAULT_FEATURES + ('harmonics',)
    harmonics_module = port.preprocess.harmonics
    for call in (1, 2):
        resblock.fused_block.launches = 0
        viterbi.decode.launches = 0
        viterbi.decode_logfreq.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        contours = port.preprocess.from_audio(
            audio, pitch_model, ppg_model, features=all_features,
            config=config, device=device)[-1]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        harmonics_launches = {
            'resblock': resblock.fused_block.launches,
            'viterbi': viterbi.decode.launches,
            'viterbi_logfreq': viterbi.decode_logfreq.launches}
        track = harmonic_track(10., config.SAMPLE_RATE, config.HOPSIZE)
        median_error_hz = [
            float(np.median(np.abs(
                contours[k].cpu().numpy() - (k + 1) * track)))
            for k in range(config.MAX_HARMONICS)]
        bin_hz = float(stft_axis[1] - stft_axis[0])
        finite = bool(torch.isfinite(contours).all())
        emit(phase='harmonics_path', call=call, seconds=seconds,
             shape=list(contours.shape), finite=finite, bin_hz=bin_hz,
             median_error_hz=median_error_hz, launches=harmonics_launches,
             logfreq_decodes=config.MAX_HARMONICS)
        if tuple(contours.shape) != (config.MAX_HARMONICS, frames_10s) \
                or not finite or max(median_error_hz) > 3 * bin_hz:
            raise AssertionError('harmonic contours are wrong')
        # F0, then every other harmonic in one batched launch
        if harmonics_launches != {
                'resblock': 0, 'viterbi': 1,
                'viterbi_logfreq': 1 + (config.MAX_HARMONICS > 1)}:
            raise AssertionError(f'harmonics launches {harmonics_launches}')
    launches['viterbi_logfreq'] = harmonics_launches['viterbi_logfreq']
    harmonics_ms = elapsed_ms(torch, lambda: harmonics_module.from_audio(
        audio, config=config, device=device), repeats=3, warmup=1)

    # The 10 s STFT frames decoded by `harmonics.viterbi` through the kernel
    # and through the plain scan over the dense transition, both on the
    # card: the mask, the initial distribution and the cached band table
    # are the path's own, and the contours must be equal
    spectra, axis = harmonics_module.stft_features(
        audio, config=config, device=device)
    through_kernel = harmonics_module.viterbi(
        spectra, axis, max_harmonics=3)
    dense = viterbi.logfreq_transition_dense(axis).to(device)

    def plain_logfreq(observation, frequencies, initial):
        if observation.dim() == 3:
            return torch.stack([
                plain_logfreq(sequence, frequencies, initial)
                for sequence in observation])
        return viterbi.backtrace_plain(
            *viterbi.forward_plain(observation, dense, initial))

    kernel_logfreq = viterbi.decode_logfreq
    viterbi.decode_logfreq = plain_logfreq
    try:
        through_plain = harmonics_module.viterbi(
            spectra, axis, max_harmonics=3)
    finally:
        viterbi.decode_logfreq = kernel_logfreq
    del dense
    differing = int((through_kernel != through_plain).sum())
    nearest = torch.from_numpy(axis).to(device)
    k3_error = max(k3_error, int((
        torch.searchsorted(nearest, through_kernel.contiguous()) -
        torch.searchsorted(nearest, through_plain.contiguous())
    ).abs().max()))
    emit(phase='harmonics_full_width_reference', frames=spectra.shape[0],
         states=spectra.shape[1], differing_frames=differing,
         equal=differing == 0)
    if differing:
        raise AssertionError('kernel and plain harmonics disagree')

    # The same STFT frames decoded on the card and by the plain CPU path
    spectra, axis = harmonics_module.stft_features(
        small, config=config, device=device)
    on_card = harmonics_module.viterbi(
        spectra, axis, max_harmonics=3).cpu().numpy()
    on_cpu = harmonics_module.viterbi(
        spectra.cpu(), axis, max_harmonics=3).numpy()
    whole = harmonics_module.from_audio(small, config=config, device='cpu')
    record = dict(
        phase='harmonics_reference', frames=spectra.shape[0],
        equal=bool(np.array_equal(on_card, on_cpu)),
        share_equal_from_audio=float(
            (harmonics_module.from_audio(
                small, config=config, device=device).cpu() == whole
             ).float().mean()))
    emit(**record)
    if not record['equal']:
        raise AssertionError('card and CPU harmonics disagree')

    out_frames = round(frames_10s * 1.4)
    edited_ms = {}
    for label, edit_config, extra in (
        ('default', config, {}),
        ('dsp_selective', config.replace(PITCH_ESTIMATOR='dsp'),
         {'stretch_unvoiced': False}),
    ):
        generator.config = edit_config
        for call in (1, 2):
            resblock.fused_block.launches = 0
            viterbi.decode.launches = 0
            torch.cuda.synchronize()
            start = time.perf_counter()
            output = port.synthesize.from_edited_audio(
                audio, pitch_model, ppg_model, generator, speaker=3,
                device=device, **EDIT, **extra)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            edit_launches = {'resblock': resblock.fused_block.launches,
                             'viterbi': viterbi.decode.launches}
            finite = bool(np.isfinite(output).all())
            emit(phase='from_edited_audio', path=label, call=call,
                 seconds=seconds, samples=output.shape[-1], finite=finite,
                 realtime_factor=10. / seconds, launches=edit_launches)
            if not finite or \
                    output.shape != (1, out_frames * config.HOPSIZE):
                raise AssertionError('from_edited_audio output is wrong')
            if edit_launches != {'resblock': 12, 'viterbi': 1}:
                raise AssertionError(
                    f'from_edited_audio launches {edit_launches}')
        edited_ms[label] = seconds * 1e3
    generator.config = config
    emit(phase='second_path_stages', harmonics_ms=harmonics_ms,
         from_edited_audio_ms=edited_ms)

    # 7 to 11. The rest of the serving surface
    path_launches = serving_paths(
        torch, port, config, device, audio, features, pitch_model, ppg_model,
        generator)
    emit(phase='serving_paths', launches=path_launches)

    # 12 and 13. Zero-shot speakers, and the three CLIs in processes of
    # their own
    path_launches['zeroshot'] = zeroshot_path(
        torch, port, device, audio, features, edited_main, pitch_model,
        ppg_model)
    path_launches['cli'] = cli_path(
        torch, port, device, audio, config, pitch_model, ppg_model,
        generator, tf32_defaults)
    emit(phase='speaker_and_cli_paths', launches={
        name: path_launches[name] for name in ('zeroshot', 'cli')})

    # 14. The evaluation path
    path_launches['evaluation'], k1_evaluation_error, k2_evaluation_error = \
        evaluation_path(
            torch, port, device, config, pitch_model, ppg_model, generator)
    k1_error = max(k1_error, k1_evaluation_error)
    k2_error = max(k2_error, k2_evaluation_error)

    # 15. The training path, whose corpus phases 19 to 21 read again
    (ROOT / 'build').mkdir(exist_ok=True)
    corpus_directory = tempfile.TemporaryDirectory(dir=ROOT / 'build')
    path_launches['training'], k1_training_error, k2_training_error = \
        training_path(torch, port, device, config, pitch_model, ppg_model,
                      edited_main, corpus_directory.name)
    k1_error = max(k1_error, k1_training_error)
    k2_error = max(k2_error, k2_training_error)

    # 15a to 15c. Resident training, the pause and the notifications, one
    # rank under NCCL; on the corpus of phase 15
    path_launches['resident_training'], k1_resident_error = \
        resident_training_path(
            torch, port, device, config, corpus_directory.name)
    k1_error = max(k1_error, k1_resident_error)
    path_launches['pause_notify'] = pause_notify_path(
        torch, port, device, config, corpus_directory.name)
    path_launches['data_parallel'] = data_parallel_path(
        torch, port, device, config, corpus_directory.name)

    # 16 to 18. FARGAN training, the exported program and the pack CLI,
    # CARGAN
    path_launches['fargan_training'] = fargan_training_path(
        torch, port, device, config, pitch_model, ppg_model)
    path_launches['export'], k1_export_error = export_path(
        torch, port, device, config, features, generator)
    k1_error = max(k1_error, k1_export_error)
    path_launches['cargan'] = cargan_path(
        torch, port, device, config, features, generator)
    emit(phase='later_paths', launches={
        name: path_launches[name]
        for name in ('fargan_training', 'export', 'cargan')})

    # 19 to 22. The feature extractors trained on the card, read back and
    # run; from_probabilities and the short inputs
    extractor_config = extractor_training_path(
        torch, port, device, config, corpus_directory.name)
    extractor_card_vs_cpu(torch, port, device, extractor_config)
    k2_call_sites = {'main_path': launches['viterbi']}
    k2_call_sites['trained_extractors'], k2_extractor_error = \
        trained_extractors_path(torch, port, device, extractor_config, audio)
    k2_call_sites['from_probabilities'], k2_probabilities_error = \
        from_probabilities_path(
            torch, port, device, config, audio,
            port.load.speaker_encoder(config=extractor_config, device=device))
    k2_error = max(k2_error, k2_extractor_error, k2_probabilities_error)

    # 22a. The speaker layout and the figures
    plot_path(torch, port, device, config, corpus_directory.name,
              port.load.speaker_encoder(
                  config=extractor_config, device=device))
    corpus_directory.cleanup()

    # 22b. The shipped checkpoints, read without JAX, and the edit chain
    # with the release generator
    k1_call_sites = {'main_path': launches['resblock']}
    k1_call_sites['shipped_weights'], k2_call_sites['shipped_weights'] = \
        shipped_weights_path(torch, port, device, audio)

    # 22c. run.sh's dataset chain through the port's command lines
    pipeline = dataset_pipeline_path(torch, port, device, smi, tf32_defaults)
    k1_call_sites['dataset_pipeline'] = pipeline['resblock']
    k2_call_sites['dataset_pipeline'] = pipeline['viterbi']

    # 23. Kernel times at the main path's shapes
    k1 = dict(ms=0., plain_ms=0., library_ms=0., bound_ms=0.)
    bound_by_kind = {'operations': 0., 'bytes': 0.}
    for frames, channels in shapes:
        for kernel_size in KERNEL_SIZES:
            x, weights, biases = block_problem(
                torch, rng, 1, frames, channels, kernel_size, device)
            launches_before = resblock.fused_block.launches
            # Packed once, as `models.hifigan.Block` does
            packed = resblock.pack_weights(weights, biases)
            ms_by_tiles = {
                tiles: elapsed_ms(torch, lambda: resblock.fused_block(
                    x, packed, None, DILATIONS, 0.1, tiles=tiles))
                for tiles in ((1, 2, 4) if channels <= 64 else (1, 2))}
            times = dict(
                ms=elapsed_ms(torch, lambda: resblock.fused_block(
                    x, packed, None, DILATIONS, 0.1)),
                plain_ms=elapsed_ms(torch, lambda: resblock.reference_block(
                    x, weights, biases, DILATIONS, 0.1, torch.bfloat16),
                    repeats=2, warmup=1),
                library_ms=elapsed_ms(
                    torch, lambda: library_block(torch, x, weights, biases)))
            resblock.fused_block.launches = launches_before
            bound, kind = block_bound_ms(1, frames, channels, kernel_size)
            bound_by_kind[kind] += bound
            flops = 2. * frames * channels * channels * kernel_size * 6
            emit(phase='time', kernel='resblock', frames=frames,
                 channels=channels, kernel_size=kernel_size, bound_ms=bound,
                 bound_by=kind, tflops=flops / times['ms'] / 1e9,
                 cuda_launches_per_block=resblock.kernel_launches(
                     channels, DILATIONS),
                 row_tiles=resblock.choose_tiles(channels),
                 ms_by_tiles=ms_by_tiles, **times)
            for key, value in times.items():
                k1[key] += value
            k1['bound_ms'] += bound

    observation = observations['random'].to(device)
    # The analysed transition, as `preprocess.pitch.decode` holds it
    band = viterbi.banded(transition)
    launches_before = viterbi.decode.launches
    k2_ms = elapsed_ms(
        torch, lambda: viterbi.decode(observation, band, initial))
    k2_forward_ms = elapsed_ms(torch, lambda: viterbi._decode_cuda(
        observation, band, initial, phases=1))
    scratch = viterbi._decode_cuda(observation, band, initial, phases=1)
    k2_backtrace_ms = elapsed_ms(torch, lambda: viterbi._decode_cuda(
        observation, band, initial, phases=2, scratch=scratch))
    long_observation = next(
        observation for label, observation, _ in k2_checks
        if label == '4096_frames').to(device)
    k2_long_ms = elapsed_ms(
        torch, lambda: viterbi.decode(long_observation, band, initial))
    viterbi.decode.launches = launches_before
    k2_plain_ms = elapsed_ms(
        torch, lambda: viterbi.backtrace_plain(*viterbi.forward_plain(
            observation, transition, initial)), repeats=2, warmup=1)
    emit(phase='time', kernel='viterbi', frames=observation.shape[0],
         states=observation.shape[1], ms=k2_ms, forward_ms=k2_forward_ms,
         backtrace_ms=k2_backtrace_ms, plain_ms=k2_plain_ms,
         us_per_frame=1e3 * k2_forward_ms / (observation.shape[0] - 1),
         ms_at_4096_frames=k2_long_ms,
         band_entries=band.entries, table_in_shared=band.table_in_shared)
    # Operations this data needs: one add and one compare per candidate
    # inside the transition's band (entries at the -1e30 floor never win)
    states = observation.shape[1]
    band = int((transition > viterbi.NEG_INF / 2).sum())
    k2_ops = 2. * (observation.shape[0] - 1) * band
    k2_bytes = 4. * (observation.numel() + states * states + states +
                     observation.shape[0])
    log_initial = torch.log_softmax(
        torch.linspace(0., -7., len(stft_axis)), -1).to(device)
    launches_before = viterbi.decode_logfreq.launches
    k3_ms = elapsed_ms(torch, lambda: viterbi.decode_logfreq(
        k3_observation, stft_axis, log_initial))
    k3_forward_ms = elapsed_ms(torch, lambda: viterbi._decode_logfreq_cuda(
        k3_observation, stft_axis, log_initial, 3.5, phases=1))
    scratch = viterbi._decode_logfreq_cuda(
        k3_observation, stft_axis, log_initial, 3.5, phases=1)
    k3_backtrace_ms = elapsed_ms(torch, lambda: viterbi._decode_logfreq_cuda(
        k3_observation, stft_axis, log_initial, 3.5, phases=2,
        scratch=scratch))
    k3_pair = torch.stack([k3_observation, k3_observation.flip(0)])
    k3_pair_ms = elapsed_ms(torch, lambda: viterbi.decode_logfreq(
        k3_pair, stft_axis, log_initial))
    k3_grid_ms = elapsed_ms(torch, lambda: viterbi._decode_logfreq_cuda(
        k3_observation, stft_axis, log_initial, 3.5, route='grid'))
    dense = viterbi.logfreq_transition_dense(stft_axis).to(device)
    k3_plain_ms = elapsed_ms(
        torch, lambda: viterbi.backtrace_plain(*viterbi.forward_plain(
            k3_observation, dense, log_initial)), repeats=2, warmup=1)
    del dense
    # Operations this data needs: one add and one compare per frame for
    # every (source, destination) pair inside the band table's runs.
    # Bytes moved once: observation and initial in, two-byte predecessors
    # and the path out, the band table with its offsets and first sources
    # in.
    table_values, table_offsets, _, _ = viterbi.band_table(stft_axis)
    k3_frames, k3_states = k3_observation.shape
    k3_ops = 2. * (k3_frames - 1) * len(table_values)
    k3_bytes = (
        4. * (k3_frames * k3_states + k3_states + k3_frames +
              len(table_values) + len(table_offsets) + k3_states) +
        viterbi.logfreq_entry_dtype(k3_states).itemsize *
        (k3_frames - 1) * k3_states)
    # The same number of frames over 200 states: next to no work per
    # frame, so what is left is the per-frame latency (two block barriers
    # and the hand-over of alpha), by cluster size
    narrow_axis = np.linspace(50., 8000., 200)
    narrow = k3_observation[:, :200].contiguous()
    narrow_initial = log_initial[:200].contiguous()
    k3_narrow_ms = elapsed_ms(torch, lambda: viterbi.decode_logfreq(
        narrow, narrow_axis, narrow_initial))
    k3_narrow_ms_by_cluster = {
        blocks: elapsed_ms(torch, lambda: viterbi._decode_logfreq_cuda(
            narrow, narrow_axis, narrow_initial, 3.5, route=blocks))
        for blocks in (1, 2, 4)}
    # The reading behind `viterbi.DESTINATION_ROWS`, the cost of a
    # destination in table rows when the groups are split over a cluster's
    # blocks: the same decode with other values, each on a plan built anew
    k3_ms_by_destination_rows = {viterbi.DESTINATION_ROWS: k3_ms}
    destination_rows = viterbi.DESTINATION_ROWS
    try:
        for value in (0, destination_rows // 4, 4 * destination_rows):
            viterbi.DESTINATION_ROWS = value
            viterbi._logfreq_plan_on.cache_clear()
            k3_ms_by_destination_rows[value] = elapsed_ms(
                torch, lambda: viterbi.decode_logfreq(
                    k3_observation, stft_axis, log_initial))
    finally:
        viterbi.DESTINATION_ROWS = destination_rows
        viterbi._logfreq_plan_on.cache_clear()
    # Where a frame's time goes: the kernel's counting variant reads the
    # clock of thread 0 of the cluster's first and last block around each
    # section of a frame; its path must be the kernel's
    cycles = torch.zeros(
        (2, len(viterbi.LOGFREQ_SECTIONS)), dtype=torch.int64, device=device)
    counted = viterbi._decode_logfreq_cuda(
        k3_observation, stft_axis, log_initial, 3.5, cycles=cycles)
    uncounted = viterbi.decode_logfreq(k3_observation, stft_axis, log_initial)
    torch.cuda.synchronize()
    if not torch.equal(counted, uncounted):
        raise AssertionError('the counting variant decodes another path')
    k3_cycles_per_frame = {
        block: {
            name: float(count) / (k3_frames - 1)
            for name, count in zip(viterbi.LOGFREQ_SECTIONS, row.tolist())}
        for block, row in zip(('first_block', 'last_block'), cycles.cpu())}
    viterbi.decode_logfreq.launches = launches_before
    emit(phase='time', kernel='viterbi_logfreq', frames=k3_frames,
         states=k3_states, in_band_pairs=len(table_values),
         route=k3_route[0], cluster_blocks=k3_route[1], ms=k3_ms,
         forward_ms=k3_forward_ms, backtrace_ms=k3_backtrace_ms,
         batch_of_2_ms=k3_pair_ms, grid_route_ms=k3_grid_ms,
         plain_ms=k3_plain_ms, operations=k3_ops, bytes=k3_bytes,
         ms_at_200_states=k3_narrow_ms,
         ms_at_200_states_by_cluster_blocks=k3_narrow_ms_by_cluster,
         ms_by_destination_rows=k3_ms_by_destination_rows,
         cycles_per_frame=k3_cycles_per_frame,
         us_per_frame=1e3 * k3_forward_ms / (k3_frames - 1),
         us_per_frame_at_200_states=1e3 * k3_narrow_ms / (k3_frames - 1))
    kernels = [
        dict(name='resblock', route='cuda',
             source='promonet_tpu_torch/csrc/resblock.cu',
             replaces='promonet_tpu/ops/resblock.py:253',
             launches=launches['resblock'],
             launches_by_call_site=k1_call_sites, max_abs_err=k1_error,
             ms=k1['ms'], plain_ms=k1['plain_ms'],
             bound_ms=k1['bound_ms'],
             bound_by=max(bound_by_kind, key=bound_by_kind.get),
             library_ms=k1['library_ms']),
        dict(name='viterbi', route='cuda',
             source='promonet_tpu_torch/csrc/viterbi.cu',
             replaces='promonet_tpu/ops/viterbi.py:405',
             launches=launches['viterbi'],
             launches_by_call_site=k2_call_sites,
             max_abs_err=float(k2_error),
             ms=k2_ms, plain_ms=k2_plain_ms,
             bound_ms=max(k2_ops / PEAK_FP32, k2_bytes / PEAK_BYTES) * 1e3,
             bound_by='operations' if k2_ops / PEAK_FP32 >
             k2_bytes / PEAK_BYTES else 'bytes',
             library_ms=None),
        dict(name='viterbi_logfreq', route='cuda',
             source='promonet_tpu_torch/csrc/viterbi_logfreq.cu',
             replaces='promonet_tpu/ops/viterbi.py:287',
             launches=launches['viterbi_logfreq'],
             max_abs_err=float(k3_error),
             ms=k3_ms, plain_ms=k3_plain_ms,
             bound_ms=max(k3_ops / PEAK_FP32, k3_bytes / PEAK_BYTES) * 1e3,
             bound_by='operations' if k3_ops / PEAK_FP32 >
             k3_bytes / PEAK_BYTES else 'bytes',
             library_ms=None),
        MEASURED['k4']]
    emit(phase='phase_seconds', seconds=dict(PHASE_SECONDS))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
