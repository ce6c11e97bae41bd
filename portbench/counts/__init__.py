"""Operations and bytes from shapes, and the table of peaks

Each function counts what the algorithm needs at the given true
lengths: multiply-adds count 2 operations; convolutions and matrix
products only (activations, norms and elementwise work are not
counted, so a share of peak computed from them is a lower bound).
"""
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / 'peaks.json').read_text())


def peaks(device_name):
    """{'bfloat16', 'float32', 'bytes'} per second of the card named
    `device_name`, or None for a card the table does not hold"""
    return PEAKS.get(device_name)


###############################################################################
# HiFi-GAN and its residual block (K1)
###############################################################################


def block_flops(batch, samples, channels, kernel_size, convs=6):
    """One Block: six stride-1 convolutions of C x C x k"""
    return 2. * batch * samples * channels * channels * kernel_size * convs


def block_bytes(batch, samples, channels, kernel_size, convs=6, width=2):
    """One Block in bf16: its input and output once, its weights and
    biases once"""
    return width * (2 * batch * samples * channels +
                    convs * kernel_size * channels * channels +
                    convs * channels)


def k1_least_seconds(rows, config, peak):
    """Least time of the twelve Blocks of one generator call whose rows
    have `rows` true frames: per Block the larger of its operations over
    the bf16 peak and its bytes over the memory bandwidth, the bound of
    `chip_smoke.py::block_bound_ms` (ce32675) over the rows' true
    lengths, the weights read once a call"""
    total, channels = 0., config.HIFIGAN_UPSAMPLE_INITIAL_SIZE
    samples = sum(rows)
    for rate in config.HIFIGAN_UPSAMPLE_RATES:
        channels, samples = channels // 2, samples * rate
        for kernel_size in config.HIFIGAN_RESBLOCK_KERNEL_SIZES:
            total += max(
                block_flops(1, samples, channels, kernel_size) /
                peak['bfloat16'],
                block_bytes(1, samples, channels, kernel_size) /
                peak['bytes'])
    return total


def hifigan_flops(frames, config):
    """HiFi-GAN over `frames` frames: input convolution, each stage's
    transposed convolution and Blocks, output convolution"""
    channels = config.HIFIGAN_UPSAMPLE_INITIAL_SIZE
    features = (config.PPG_CHANNELS + config.LOUDNESS_BANDS + 1 +
                config.PITCH_EMBEDDING_SIZE)
    total = 2. * frames * features * channels * 7
    samples = frames
    for rate, kernel in zip(config.HIFIGAN_UPSAMPLE_RATES,
                            config.HIFIGAN_UPSAMPLE_KERNEL_SIZES):
        total += 2. * samples * channels * (channels // 2) * kernel
        channels, samples = channels // 2, samples * rate
        for kernel_size in config.HIFIGAN_RESBLOCK_KERNEL_SIZES:
            total += block_flops(1, samples, channels, kernel_size)
    return total + 2. * samples * channels * 7


###############################################################################
# FARGAN
###############################################################################


def fargan_flops(frames, config, hopsize=256, subframe=64, subframes=4):
    """FARGAN over `frames` frames: the conditioning network over every
    frame, then per subframe the framewise convolution, three GRUs and
    GLUs, the skip path and the output layer"""
    features = (config.PPG_CHANNELS + config.LOUDNESS_BANDS + 1 +
                config.PITCH_EMBEDDING_SIZE + config.SPEAKER_CHANNELS + 2)
    conditioning = features * features + features * features + \
        features * 2 * hopsize
    gru_in = hopsize + 2 * subframe
    step = (
        2 * (4 * subframe + 4) * hopsize + hopsize * hopsize +  # fwconv
        3 * (3 * hopsize * gru_in + 3 * hopsize * hopsize) +    # GRUs
        3 * hopsize * hopsize +                                 # GLUs
        (4 * hopsize + 2 * subframe) * hopsize + hopsize * hopsize +
        hopsize * subframe)                                     # skip, out
    return 2. * frames * (conditioning + subframes * step)


###############################################################################
# Preprocess: pitch CNN, Viterbi decode (K2), PPG encoder
###############################################################################


def pitch_cnn_flops(frames, channels=(128, 32, 32, 64, 128, 256),
                    kernel_sizes=(32, 16, 8, 8, 8, 4), strides=(4, 2, 2, 1, 1, 1),
                    bins=256):
    """The pitch CNN over `frames` frames of 1024 samples: (convolutions,
    the output layer's matrix product)"""
    total, length, previous = 0., 1024, 1
    for out, kernel, stride in zip(channels, kernel_sizes, strides):
        length = -(-length // stride)
        total += 2. * length * previous * out * kernel
        previous = out
    return frames * total, frames * 2. * length * previous * bins


def ppg_flops(frames, mels=80, bins=513, channels=256, layers=6, kernel=5,
              phonemes=40):
    """The PPG side over `frames` frames: (the encoder's convolutions, the
    mel projection's and the output layer's matrix products)"""
    return 2. * frames * (mels * channels * kernel +
                          (layers - 1) * channels * channels * kernel), \
        2. * frames * (mels * bins + channels * phonemes)


def preprocess_least_seconds(frames, peak):
    """Least time of the pitch CNN and the PPG side over `frames` input
    frames: their convolutions (cuDNN, which PyTorch lets use TF32 by
    default) at the TF32 peak, their matrix products (which it keeps in
    float32) at the float32 peak"""
    pitch, ppg = pitch_cnn_flops(frames), ppg_flops(frames)
    return (pitch[0] + ppg[0]) / peak['tfloat32'] + \
        (pitch[1] + ppg[1]) / peak['float32']


def k2_least_seconds(frames, peak, states=256, band=17):
    """Least time of one Viterbi decode of `frames` frames: per frame and
    state an add and a compare over the band of the triangular transition
    (17 predecessors) against the float32 peak, or the float32
    observation read once and the int32 path written once against the
    memory bandwidth"""
    operations = 2. * frames * states * band
    moved = 4. * (frames * states + states * band + states + frames)
    return max(operations / peak['float32'], moved / peak['bytes'])


###############################################################################
# Training: the discriminators (models/discriminator.py)
###############################################################################


def _conv2d_flops(height, width, cin, cout, kernel, stride, padding):
    """(flops, out height, out width) of one 2-D convolution"""
    out_h = (height + 2 * padding[0] - kernel[0]) // stride[0] + 1
    out_w = (width + 2 * padding[1] - kernel[1]) // stride[1] + 1
    return 2. * out_h * out_w * cin * cout * kernel[0] * kernel[1], out_h, \
        out_w


def mpd_flops(samples, periods=(2, 3, 5, 7, 11)):
    """The multi-period discriminator over one row of `samples`"""
    total = 0.
    for period in periods:
        height, width = -(-samples // period), period
        for cin, cout, stride, kernel, padding in (
            (1, 32, 3, 5, 2), (32, 128, 3, 5, 2), (128, 512, 3, 5, 2),
            (512, 1024, 3, 5, 2), (1024, 1024, 1, 5, 2), (1024, 1, 1, 3, 1)
        ):
            flops, height, width = _conv2d_flops(
                height, width, cin, cout, (kernel, 1), (stride, 1),
                (padding, 0))
            total += flops
    return total


def cmb_flops(samples, window=1024, hopsize=256, channels=32):
    """The complex multi-band discriminator over one row of `samples`"""
    frames = (samples + window - hopsize - window) // hopsize + 1
    bins = window // 2 + 1
    total, widths = 0., []
    for low, high in ((0., .1), (.1, .25), (.25, .5), (.5, .75), (.75, 1.)):
        width, cin = int(high * bins) - int(low * bins), 1
        for kernel, stride, padding in (
            ((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)),
            ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
            ((3, 3), (1, 1), (1, 1))
        ):
            flops, _, width = _conv2d_flops(
                frames, width, cin, channels, kernel, stride, padding)
            total += flops
            cin = channels
        widths.append(width)
    return total + _conv2d_flops(
        frames, sum(widths), channels, 1, (3, 3), (1, 1), (1, 1))[0]


def train_step_flops(rows, samples, config):
    """Convolution FLOPs of one GAN step: the generator forward and
    backward (3 forwards; its recomputation not counted); the
    discriminators over real and fake audio in their own step, forward
    and backward (6 forwards), and in the generator's step forward over
    both and backward over the fake through its input (3 forwards)"""
    generator = hifigan_flops(samples // config.HOPSIZE, config)
    discriminators = mpd_flops(samples) + cmb_flops(samples)
    return rows * (3. * generator + 9. * discriminators)
