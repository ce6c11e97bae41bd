"""Default configuration values of the PyTorch port.

A copy of the constants that the editing chain reads from the JAX
package's defaults (`promonet_tpu/config/defaults.py`). Names and values
are identical, so the same override files (`configs/*.py`,
`runs/<run>/<config>.py`) configure both packages. Constants of parts
that are not ported yet (training, discriminators, evaluation) are left
out; an override file may still set them, and they are carried on the
`Config` object unread.
"""
from pathlib import Path


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

# Condition the generator on spectrograms alone (not ported)
SPECTROGRAM_ONLY = False

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


###############################################################################
# Directories
###############################################################################


# Shipped assets of the JAX package (pitch statistics), read by path only
ASSETS_DIR = Path(__file__).parent.parent.parent / 'promonet_tpu' / 'assets'


###############################################################################
# Generator
###############################################################################


# Conditioning features fed to the generator
INPUT_FEATURES = ['loudness', 'pitch', 'periodicity', 'ppg']

# Negative-side slope of every leaky ReLU
LRELU_SLOPE = .1

# Vocoder backbone: 'hifigan', 'fargan' or 'vocos' ('cargan' is not
# ported)
MODEL = 'hifigan'

# CARGAN: waveform lookback window feeding the autoregressive encoder
# (NUM_PREVIOUS_SAMPLES when MODEL is 'cargan')
CARGAN_INPUT_SIZE = 2 * HOPSIZE

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

# Vocos: ConvNeXt trunk width
VOCOS_CHANNELS = 512

# Vocos: ConvNeXt inverted-bottleneck width
VOCOS_POINTWISE_CHANNELS = 1536

# Vocos: ConvNeXt depth
VOCOS_LAYERS = 6

# Condition on WavLM x-vectors instead of a learned speaker table
# (not ported)
ZERO_SHOT = False


###############################################################################
# Inference
###############################################################################


# Computation dtype of the generator ('bfloat16' or 'float32')
PRECISION = 'bfloat16'

# Pad-to-bucket frame counts for variable-length inference. The port
# keeps the JAX package's ladder: padding changes the tail frames of the
# extracted features, so parity depends on it.
INFERENCE_FRAME_BUCKETS = [
    64, 128, 256, 384, 512, 640, 768, 896, 1024,
    1280, 1536, 1792, 2048, 2560, 3072, 3584, 4096]

# Pitch estimation front-end: the learned 'cnn' estimator or the 'dsp'
# normalized cross-correlation
PITCH_ESTIMATOR = 'cnn'
