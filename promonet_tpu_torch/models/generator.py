"""Generator: feature preparation + speaker conditioning + backbone

Counterpart of `promonet_tpu/models/generator.py`, with the backbones its
`BaseGenerator.setup` dispatches on `MODEL` ('hifigan', 'fargan',
'vocos') and its two speaker conditionings: a learned table of
NUM_SPEAKERS rows, or under ZERO_SHOT a Dense layer over
(WAVLM_EMBEDDING_CHANNELS,) x-vectors. `Generator` conditions on the
interpretable features, `MelGenerator` (SPECTROGRAM_ONLY) on the log-mels
of a linear spectrogram. Public layouts are the JAX package's: features
(B, C, T) in, audio (B, 1, T * HOPSIZE) out.
"""
import numpy as np
import torch
from torch import nn

from .. import config as config_module
from .. import load
from ..ops import mel as mel_ops, sparse
from ..utils import timer
from .fargan import FARGAN
from .hifigan import HiFiGAN
from .modules import Dense
from .vocos import Vocos


def _band_average(loudness, bands):
    """Average full-band loudness (B, F, T) into `bands` bands

    The final band is uneven when F % bands != 0 (int-truncated slices).
    """
    step = loudness.shape[-2] / bands
    return torch.stack(
        [
            loudness[..., int(band * step):int((band + 1) * step), :].mean(
                dim=-2)
            for band in range(bands)],
        dim=-2)


class BaseGenerator(nn.Module):
    """The backbone of config.MODEL and the speaker conditioning

    num_features: width of the (B, T, num_features) backbone input
    """

    def __init__(self, config, num_features):
        super().__init__()
        self.config = config
        self.dtype = (
            torch.bfloat16 if config.PRECISION == 'bfloat16'
            else torch.float32)
        if config.MODEL == 'hifigan':
            self.backbone = HiFiGAN(
                num_features,
                config.GLOBAL_CHANNELS,
                initial_size=config.HIFIGAN_UPSAMPLE_INITIAL_SIZE,
                upsample_kernel_sizes=tuple(
                    config.HIFIGAN_UPSAMPLE_KERNEL_SIZES),
                upsample_rates=tuple(config.HIFIGAN_UPSAMPLE_RATES),
                resblock_kernel_sizes=tuple(
                    config.HIFIGAN_RESBLOCK_KERNEL_SIZES),
                resblock_dilation_sizes=tuple(
                    tuple(d) for d in config.HIFIGAN_RESBLOCK_DILATION_SIZES),
                lrelu_slope=config.LRELU_SLOPE,
                remat=bool(getattr(config, 'REMAT', False)))
        elif config.MODEL == 'vocos':
            self.backbone = Vocos(
                num_features,
                config.GLOBAL_CHANNELS,
                channels=config.VOCOS_CHANNELS,
                pointwise_channels=config.VOCOS_POINTWISE_CHANNELS,
                num_layers=config.VOCOS_LAYERS,
                n_fft=config.NUM_FFT,
                hop_length=config.HOPSIZE)
        elif config.MODEL == 'fargan':
            self.backbone = FARGAN(
                num_features, config.GLOBAL_CHANNELS,
                num_previous=config.NUM_PREVIOUS_SAMPLES)
        else:
            raise ValueError(f'Generator model {config.MODEL} is not defined')
        if config.ZERO_SHOT:
            self.speaker_embedding = Dense(
                config.WAVLM_EMBEDDING_CHANNELS, config.SPEAKER_CHANNELS,
                bias=True)
        else:
            self.speaker_embedding = nn.Embedding(
                config.NUM_SPEAKERS, config.SPEAKER_CHANNELS)

    def prepare_global_features(
        self, speakers, spectral_balance_ratios, loudness_ratios
    ):
        """Speaker embedding ⊕ augmentation ratios, (B, 1, G)

        The zero-shot Dense computes in the generator's dtype, as Flax's
        `nn.Dense(dtype=...)` does: in bf16 the embedding is rounded to
        bf16 before the ratios join it.
        """
        if self.config.ZERO_SHOT:
            embedding = self.speaker_embedding(speakers.float(), self.dtype)
        else:
            embedding = self.speaker_embedding(speakers)
        columns = [embedding.float()[:, None, :]]
        if self.config.AUGMENT_PITCH:
            columns.append(spectral_balance_ratios.float()[:, None, None])
        if self.config.AUGMENT_LOUDNESS:
            columns.append(loudness_ratios.float()[:, None, None])
        return torch.cat(columns, dim=-1).to(self.dtype)

    def backbone_forward(self, features, global_features, train):
        """The backbone's (B, T, 1) audio; `train` as the JAX package
        passes it: HiFi-GAN's differentiable route, no effect on Vocos"""
        if self.config.MODEL == 'hifigan':
            return self.backbone(features, global_features, self.dtype, train)
        return self.backbone(features, global_features, self.dtype)


class Generator(BaseGenerator):
    """Proposed generator over interpretable features"""

    def __init__(self, config=None):
        config = config_module.default() if config is None else config
        if config.SPECTROGRAM_ONLY:
            raise ValueError(
                'A SPECTROGRAM_ONLY configuration conditions on '
                'spectrograms: build models.MelGenerator (load.generator '
                'does)')
        # FARGAN takes one more input channel: the pitch period
        super().__init__(
            config, config.NUM_FEATURES + (config.MODEL == 'fargan'))
        if config.VARIABLE_PITCH_BINS:
            # A buffer outside the state dict, so that it moves with the
            # generator (a cast below float32 would round it: nothing
            # casts the generator, whose weights stay float32)
            self.register_buffer('pitch_distribution', torch.from_numpy(
                np.asarray(load.pitch_distribution(config), np.float32)),
                persistent=False)
        if 'pitch' in config.INPUT_FEATURES and config.PITCH_EMBEDDING:
            self.pitch_embed = nn.Embedding(
                config.PITCH_BINS, config.PITCH_EMBEDDING_SIZE)

    def forward(
        self,
        loudness,
        pitch,
        periodicity,
        ppg,
        speakers,
        spectral_balance_ratios,
        loudness_ratios,
        initial_states=None,
        return_states=False,
        train=False,
        previous_samples=None,
        noise=None,
        true_frames=None
    ):
        """
        Arguments
            loudness: (B, F, T) full-band A-weighted loudness
            pitch: (B, T) pitch in Hz
            periodicity: (B, T)
            ppg: (B, PPG_CHANNELS, T)
            speakers: (B,) int speaker ids, or under ZERO_SHOT (B,
                WAVLM_EMBEDDING_CHANNELS) float32 x-vectors
            spectral_balance_ratios: (B,)
            loudness_ratios: (B,)
            initial_states / return_states: FARGAN's carry, for streaming
                that continues where the last call stopped
                (`models.fargan.FARGAN.forward`); other backbones ignore
                them
            train: the training route: HiFi-GAN's runs no kernel and is
                recomputed under REMAT (`models.hifigan`), FARGAN's frame
                loop is one that autograd runs (`models.fargan`)
            previous_samples: (B, 1, NUM_PREVIOUS_SAMPLES) audio before
                the first frame, FARGAN's starting history (zeros where
                None); other backbones ignore it
            noise: FARGAN's training noise source (`models.fargan.Uniform`
                or a callable like it), read with train only; None adds
                no noise
            true_frames: how many of the B x T frames are real input, not
                padding or repeated rows; None: all of them. It only
                counts, for the `vocoder` span

        Returns
            audio: (B, 1, T * HOPSIZE), float32 [, FARGAN's final carry]

        The backbone's part, after the features are assembled, is the span
        `vocoder` (`utils.timer.span`), which counts `frames` (B x T) and
        `true_frames`.
        """
        features = self.prepare_features(loudness, pitch, periodicity, ppg)
        global_features = self.prepare_global_features(
            speakers, spectral_balance_ratios, loudness_ratios)
        frames = features.shape[0] * features.shape[1]
        with timer.span('vocoder', frames=frames, true_frames=(
                frames if true_frames is None else true_frames)):
            if self.config.MODEL == 'fargan':
                out = self.backbone(
                    features, global_features, self.dtype,
                    initial_states=initial_states,
                    return_states=return_states,
                    previous_samples=previous_samples, train=train,
                    noise=noise)
                if return_states:
                    return out[0].transpose(1, 2), out[1]
                return out.transpose(1, 2)
            audio = self.backbone_forward(features, global_features, train)
            return audio.transpose(1, 2)

    def prepare_features(self, loudness, pitch, periodicity, ppg):
        """Assemble the (B, T, NUM_FEATURES) network input"""
        config = self.config
        if config.SPARSE_PPG_METHOD is not None:
            ppg = sparse.sparsify(
                ppg, config.SPARSE_PPG_METHOD, config.SPARSE_PPG_THRESHOLD)
        columns = [ppg.transpose(-1, -2)]

        if 'pitch' in config.INPUT_FEATURES:
            hz = torch.clamp(pitch, config.FMIN, config.FMAX)
            normalized = (
                (torch.log2(hz) - config.LOG_FMIN) /
                (config.LOG_FMAX - config.LOG_FMIN))
            if not config.PITCH_EMBEDDING:
                columns.append(normalized[..., None])
            else:
                if config.VARIABLE_PITCH_BINS:
                    distribution = self.pitch_distribution
                    # right=False is jnp.searchsorted's default side
                    bins = torch.searchsorted(
                        distribution, hz.contiguous(), right=False)
                    bins = torch.clamp(bins, 0, config.PITCH_BINS - 1)
                else:
                    bins = ((config.PITCH_BINS - 1) * normalized).long()
                columns.append(self.pitch_embed(bins))

        if 'loudness' in config.INPUT_FEATURES:
            averaged = _band_average(loudness, config.LOUDNESS_BANDS)
            normalized = (
                (averaged - config.MIN_DB) / (config.REF_DB - config.MIN_DB))
            columns.append(normalized.transpose(-1, -2))

        if 'periodicity' in config.INPUT_FEATURES:
            columns.append(periodicity[..., None])

        # The pitch period in samples, for FARGAN's lookback
        if config.MODEL == 'fargan':
            columns.append((
                config.SAMPLE_RATE /
                torch.clamp(pitch, config.FMIN, config.FMAX))[..., None])

        return torch.cat([c.to(self.dtype) for c in columns], dim=-1)


class MelGenerator(BaseGenerator):
    """Generate speech from the log-mels of a linear spectrogram

    Counterpart of `promonet_tpu.models.MelGenerator`, the
    spectrogram-only baseline (SPECTROGRAM_ONLY, configs/baselines/mels.py):
    the same backbone and global features as `Generator`, over NUM_MELS
    log-mel channels. HiFi-GAN and Vocos backbones only: FARGAN's pitch
    lookup needs the pitch, which a spectrogram does not give.
    """

    def __init__(self, config=None):
        config = config_module.default() if config is None else config
        if config.MODEL == 'fargan':
            raise ValueError(
                'MelGenerator takes no pitch, which FARGAN needs')
        super().__init__(config, config.NUM_MELS)

    def forward(
        self, spectrograms, speakers, spectral_balance_ratios,
        loudness_ratios, train=False
    ):
        """
        Arguments
            spectrograms: (B, NUM_FFT // 2 + 1, T) linear magnitudes
            speakers, spectral_balance_ratios, loudness_ratios: as
                `Generator.forward` takes them

        Returns
            audio: (B, 1, T * HOPSIZE), float32
        """
        features = self.prepare_features(spectrograms)
        global_features = self.prepare_global_features(
            speakers, spectral_balance_ratios, loudness_ratios)
        return self.backbone_forward(
            features, global_features, train).transpose(1, 2)

    def prepare_features(self, spectrograms):
        """Linear spectrogram (B, F, T) → log-mels (B, T, NUM_MELS)"""
        config = self.config
        features = mel_ops.linear_to_mel(
            spectrograms.float(),
            config.SAMPLE_RATE,
            config.NUM_FFT,
            config.NUM_MELS,
            config.LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD)
        if config.SPARSE_MELS:
            features = features + \
                config.LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD
        return features.transpose(-1, -2).to(self.dtype)
