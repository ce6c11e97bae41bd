"""Default configuration values of the PyTorch port.

A copy of the constants that the port reads from the JAX package's
defaults (`promonet_tpu/config/defaults.py`). Names and values are
identical, so the same override files (`configs/*.py`,
`runs/<run>/<config>.py`) configure both packages. Constants the port
does not read (the TPU's conv lowering and Pallas switch, the FARGAN_*
settings the JAX generator ignores, the unused VITS and loss settings)
are left out; an override file may still set them, and they are carried
on the `Config` object unread. Every directory the port writes (the
dataset cache, its partitions, evaluation artefacts and results) lies
under `data/` at the root of the repository, outside the JAX package.
"""
from pathlib import Path

# Where everything the port writes lies (not a setting: lowercase)
_data = Path(__file__).parent.parent.parent / 'data'


###############################################################################
# Metadata
###############################################################################


# Name identifying this configuration (selects the run directory)
CONFIG = 'promonet'


###############################################################################
# Audio
###############################################################################


# Log-mel floor used when sparsifying spectrograms; None disables clamping
DYNAMIC_RANGE_COMPRESSION_THRESHOLD = None

# Pitch search range bounds
FMIN = 50.  # Hz
FMAX = 550.  # Hz

# Samples between analysis frames
HOPSIZE = 256  # samples

# Number of speech harmonic contours (F0..Fk) the harmonics feature decodes
MAX_HARMONICS = 3

# Loudness floor; silence clamps to this value
MIN_DB = -100.

# Mel filterbank size
NUM_MELS = 80

# FFT length for spectrograms (NUM_FFT // 2 + 1 frequency bins)
NUM_FFT = 1024

# Loudness value mapped to full scale
REF_DB = 20.

# Waveform rate used everywhere past the loader
SAMPLE_RATE = 22050  # Hz

# STFT analysis window length
WINDOW_SIZE = 1024


###############################################################################
# Data
###############################################################################


# Generator conditions on the loudness/pitch augmentation ratios
AUGMENT_LOUDNESS = True
AUGMENT_PITCH = True

# Evaluate per-speaker adaptation partitions: each held-out speaker's
# train-adapt partition fine-tunes the generator before its test-adapt
# utterances are scored
ADAPTATION = False

# Log-uniform range of the augmentation ratios (`data.augment`)
AUGMENTATION_RATIO_MAX = 2.
AUGMENTATION_RATIO_MIN = .5

# The published datasets
DATASETS = ['daps', 'libritts', 'vctk']

# Seed of every random choice of the data pipeline (corpus, partitions)
RANDOM_SEED = 1234

# Band count for the averaged A-weighted loudness conditioning
LOUDNESS_BANDS = 8

# Represent pitch as a learned per-bin embedding (vs a scalar channel)
PITCH_EMBEDDING = True

# Quantization resolution of the pitch contour
PITCH_BINS = 256

# Width of each learned pitch-bin vector
PITCH_EMBEDDING_SIZE = 64

# Phoneme categories in the posteriorgram
PPG_CHANNELS = 40

# Resampling mode when PPGs are stretched onto a new time grid
# ('linear' or 'nearest')
PPG_INTERP_METHOD = 'linear'

# PPG sparsification strategy: 'constant', 'percentile', 'topk' or None
SPARSE_PPG_METHOD = 'percentile'

# Sparsification strength (probability mass, or a count for 'topk')
SPARSE_PPG_THRESHOLD = 0.85

# Condition the generator on log-mels of the linear spectrogram alone
# (`models.MelGenerator`, configs/baselines/mels.py)
SPECTROGRAM_ONLY = False

# Shift the MelGenerator's log-mels up by the log dynamic range
# compression threshold
SPARSE_MELS = False

# Which dataset the generator was trained on (speaker count, pitch bins)
TRAINING_DATASET = 'vctk'

# Place pitch-bin boundaries at dataset pitch quantiles rather than
# uniformly in log-Hz
VARIABLE_PITCH_BINS = True

# Decode the pitch posteriors with Viterbi (vs per-frame argmax)
VITERBI_DECODE_PITCH = True

# Periodicity cutoff for the voiced/unvoiced decision
VOICING_THRESHOLD = .1625

# Speaker count of the formant-synthesis corpus
SYNTHETIC_SPEAKERS = 24

# Condition a zero-shot generator in training on another utterance of the
# same speaker
ZERO_SHOT_SHUFFLE = False


###############################################################################
# Directories
###############################################################################


# Shipped assets of the JAX package (pitch statistics, and the orbax
# checkpoints of the pitch CNN, PPG encoder and speaker encoder under
# checkpoints/, which `load` takes where CHECKPOINTS_DIR has none), read by
# path only
ASSETS_DIR = Path(__file__).parent.parent.parent / 'promonet_tpu' / 'assets'

# The port's checkpoints of the pitch CNN, the PPG encoder and the speaker
# encoder (`<name>-<step:08d>.pt`, written by `preprocess.{pitch,ppg,
# speaker}.train` or converted by scripts/convert_checkpoints.py)
CHECKPOINTS_DIR = Path(__file__).parent.parent.parent / 'checkpoints_torch'

# The port's training runs: checkpoints and metrics.jsonl under
# RUNS_DIR / CONFIG (`python -m promonet_tpu_torch.train`), adaptation
# runs beside them; a generator without a checkpoint comes from
# RUNS_DIR / CONFIG (`load.generator`). Not the JAX package's `runs/`.
RUNS_DIR = Path(__file__).parent.parent.parent / 'runs_torch'

# Extracted datasets as published, <dataset>/..., which `data.download`
# formats into CACHE_DIR (the JAX package's location; read only)
DATA_DIR = _data / 'datasets'

# Preprocessed datasets: <dataset>/<speaker>/<utterance>-100.wav and its
# feature files (the JAX package's layout and location, so a corpus made
# by either package serves both)
CACHE_DIR = _data / 'cache'

# The port's partitions: {multispeaker,adaptation}/<dataset>.json
PARTITIONS_DIR = _data / 'partitions'

# Evaluation artefacts: objective/<condition>/*.npy and
# subjective/<condition>/*.wav
EVAL_DIR = _data / 'eval'

# Evaluation results: <CONFIG>/<dataset>/results.json
RESULTS_DIR = _data / 'results'

# The port's augmentation ratio files, <dataset>-{pitch,loudness}.json
# (`data.augment`); a dataset without one here takes the JAX package's
# shipped file under ASSETS_DIR / 'augmentations', read only
AUGMENT_DIR = _data / 'augmentations'


###############################################################################
# Generator
###############################################################################


# Conditioning features fed to the generator
INPUT_FEATURES = ['loudness', 'pitch', 'periodicity', 'ppg']

# Negative-side slope of every leaky ReLU
LRELU_SLOPE = .1

# Vocoder backbone: 'hifigan', 'fargan' or 'vocos'; 'world' selects the
# WORLD baseline (baseline/world.py) in evaluation. As in the JAX package,
# the generator does not build 'cargan': `models.cargan.CARGAN` is a
# module of its own
MODEL = 'hifigan'

# CARGAN: waveform lookback window feeding the autoregressive encoder
# (NUM_PREVIOUS_SAMPLES when MODEL is 'cargan')
CARGAN_INPUT_SIZE = 2 * HOPSIZE

# CARGAN: encoder MLP width
CARGAN_HIDDEN_SIZE = 256

# CARGAN: channels the encoder contributes to the backbone input
CARGAN_OUTPUT_SIZE = 128

# FARGAN: frames of history available to the pitch-period lookback
# (NUM_PREVIOUS_SAMPLES when MODEL is 'fargan'). The JAX package's other
# FARGAN_* settings are left out: its generator builds FARGAN with the
# class defaults and reads none of them.
FARGAN_PREVIOUS_FRAMES = 2  # frames

# HiFi-GAN: parallel residual-branch kernel widths
HIFIGAN_RESBLOCK_KERNEL_SIZES = [3, 7, 11]

# HiFi-GAN: dilation schedule inside each residual branch
HIFIGAN_RESBLOCK_DILATION_SIZES = [[1, 3, 5], [1, 3, 5], [1, 3, 5]]

# HiFi-GAN: channel width entering the first upsampling stage
HIFIGAN_UPSAMPLE_INITIAL_SIZE = 512

# HiFi-GAN: transposed-conv kernel widths per stage
HIFIGAN_UPSAMPLE_KERNEL_SIZES = [16, 16, 4, 4]

# HiFi-GAN: temporal upsampling factor per stage (product = HOPSIZE)
HIFIGAN_UPSAMPLE_RATES = [8, 8, 2, 2]

# Width of the speaker identity vector
SPEAKER_CHANNELS = 256

# Width of the x-vectors a zero-shot generator conditions on
WAVLM_EMBEDDING_CHANNELS = 512

# Vocos: ConvNeXt trunk width
VOCOS_CHANNELS = 512

# Vocos: ConvNeXt inverted-bottleneck width
VOCOS_POINTWISE_CHANNELS = 1536

# Vocos: ConvNeXt depth
VOCOS_LAYERS = 6

# Condition on (WAVLM_EMBEDDING_CHANNELS,) x-vectors instead of a learned
# speaker table
ZERO_SHOT = False


###############################################################################
# Inference
###############################################################################


# Computation dtype of the generator ('bfloat16' or 'float32')
PRECISION = 'bfloat16'

# Generator checkpoint used when none is passed; None takes the newest
# port checkpoint under RUNS_DIR / CONFIG (`load.generator`)
DEFAULT_CHECKPOINT = None

# Pad-to-bucket frame counts for variable-length inference. The port
# keeps the JAX package's ladder: padding changes the tail frames of the
# extracted features, so parity depends on it.
INFERENCE_FRAME_BUCKETS = [
    64, 128, 256, 384, 512, 640, 768, 896, 1024,
    1280, 1536, 1792, 2048, 2560, 3072, 3584, 4096]

# Pitch estimation front-end: the learned 'cnn' estimator or the 'dsp'
# normalized cross-correlation
PITCH_ESTIMATOR = 'cnn'


###############################################################################
# Evaluation
###############################################################################


# Edit ratios of the evaluation's shifted, stretched, scaled, balance and
# loudness conditions
EVALUATION_RATIOS = [.717, 1.414]


###############################################################################
# Discriminators
###############################################################################


# RVQGAN-style complex multi-band STFT discriminator
COMPLEX_MULTIBAND_DISCRIMINATOR = True

# HiFi-GAN multi-period waveform discriminator
MULTI_PERIOD_DISCRIMINATOR = True

# UnivNet multi-resolution magnitude-STFT discriminator
MULTI_RESOLUTION_DISCRIMINATOR = False

# MelGAN multi-scale waveform discriminator
MULTI_SCALE_DISCRIMINATOR = False

# FARGAN's own spectral discriminator
FARGAN_DISCRIMINATOR = False


###############################################################################
# Logging
###############################################################################


# Checkpoint cadence
CHECKPOINT_INTERVAL = 20000  # steps

# Validation and metrics cadence
EVALUATION_INTERVAL = 2500  # steps

# Validation items per evaluation pass
DEFAULT_EVALUATION_STEPS = 16

# Validation items whose audio and prosody figure are logged (TensorBoard)
# per pass
PLOT_EXAMPLES = 10

# Panels drawn by the plotting module when none are requested
DEFAULT_PLOT_FEATURES = ['audio', 'loudness', 'pitch', 'periodicity', 'ppg']

# Per-frame error tolerances: a frame counts as wrong past these
ERROR_THRESHOLD_LOUDNESS = 6.  # decibels
ERROR_THRESHOLD_PERIODICITY = .1
ERROR_THRESHOLD_PITCH = 50.  # cents
ERROR_THRESHOLD_PPG = .1  # JSD


###############################################################################
# Losses
###############################################################################


# Hinge adversarial objective instead of least-squares
ADVERSARIAL_HINGE_LOSS = False

# Generator starts receiving adversarial gradient at this step
ADVERSARIAL_LOSS_START_STEP = 0

# Scale on the adversarial term
ADVERSARIAL_LOSS_WEIGHT = 1.

# Discriminator optimization begins at this step
DISCRIMINATOR_START_STEP = 0

# Scale on the feature-matching term
FEATURE_MATCHING_LOSS_WEIGHT = 1.

# Drop each discriminator's first activation from feature matching
FEATURE_MATCHING_OMIT_FIRST = False

# L1 log-mel reconstruction term
MEL_LOSS = True

# Scale on the mel term
MEL_LOSS_WEIGHT = 45.

# Normalized-correlation loss directly on waveforms
SIGNAL_LOSS = False

# Scale on the signal term
SIGNAL_LOSS_WEIGHT = .03

# Zero-floor the mels inside the mel loss
SPARSE_MEL_LOSS = False

# Multi-resolution spectral convergence term
SPECTRAL_CONVERGENCE_LOSS = False


###############################################################################
# Training
###############################################################################


# Batch size of a training step
BATCH_SIZE = 64

# Samples per training example (random crop; reflect-pad if short)
CHUNK_SIZE = 16384  # samples

# Inf-norm clip on generator gradients; None disables
GRADIENT_CLIP_GENERATOR = None

# Optimization budget
STEPS = 800000

# Additional steps when adapting to a new speaker
ADAPTATION_STEPS = 10000

# Threads of the host data loader
NUM_WORKERS = 10

# Optimizer of both models: torch.optim.AdamW with the JAX package's
# optax settings (decoupled weight decay scaled by the learning rate)
OPTIMIZER = {
    'name': 'adamw',
    'lr': 2e-4,
    'b1': .8,
    'b2': .99,
    'eps': 1e-9,
    'weight_decay': 1e-2}

# Recompute each residual Block's and each discriminator's activations in
# the backward pass (torch.utils.checkpoint)
REMAT = True

# Sizes of the axes of the process mesh (`parallel.create_mesh`). None
# puts every process of the group on the 'data' axis; training splits the
# batch over 'data' and all-reduces the gradients (`torch.distributed`)
MESH_SHAPE = None  # e.g. {'data': 4}

# Training steps run back to back from the device-resident corpus before
# the host looks at the run again (`train.core.steps_per_dispatch`): the
# metrics, evaluation, checkpoints and the pause check come once per
# dispatch. None = auto (the largest divisor <= 32 of every step cadence)
STEPS_PER_DISPATCH = None

# Device-resident training data (`data.resident`): the whole preprocessed
# training partition is packed and copied to the card once, and each
# step's crops are drawn on the card instead of read by the host loader.
# None = auto: on for a CUDA device when the model trains on
# interpretable features (not under SPECTROGRAM_ONLY)
RESIDENT_DATA = None
