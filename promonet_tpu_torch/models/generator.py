"""Generator: feature preparation + speaker conditioning + backbone

Counterpart of `promonet_tpu/models/generator.py`, with the backbones its
`BaseGenerator.setup` dispatches on `MODEL` ('hifigan', 'fargan',
'vocos') and a learned speaker table. Public layouts are the JAX
package's: features (B, C, T) in, audio (B, 1, T * HOPSIZE) out.
"""
import numpy as np
import torch
from torch import nn

from .. import config as config_module
from .. import load
from ..ops import sparse
from .fargan import FARGAN
from .hifigan import HiFiGAN
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


class Generator(nn.Module):
    """Proposed generator over interpretable features"""

    def __init__(self, config=None):
        super().__init__()
        config = config_module.default() if config is None else config
        if config.ZERO_SHOT or config.SPECTROGRAM_ONLY \
                or config.MODEL == 'cargan':
            raise NotImplementedError(
                'Zero-shot speakers (ZERO_SHOT), the spectrogram-only '
                "generator (SPECTROGRAM_ONLY) and MODEL='cargan' are not "
                'ported')
        self.config = config
        self.dtype = (
            torch.bfloat16 if config.PRECISION == 'bfloat16'
            else torch.float32)
        if config.VARIABLE_PITCH_BINS:
            # A plain attribute, not a buffer: `.to(dtype)` must not round it
            self.pitch_distribution = torch.from_numpy(
                np.asarray(load.pitch_distribution(config), np.float32))
        features = config.NUM_FEATURES
        if config.MODEL == 'hifigan':
            self.backbone = HiFiGAN(
                features,
                config.GLOBAL_CHANNELS,
                initial_size=config.HIFIGAN_UPSAMPLE_INITIAL_SIZE,
                upsample_kernel_sizes=tuple(
                    config.HIFIGAN_UPSAMPLE_KERNEL_SIZES),
                upsample_rates=tuple(config.HIFIGAN_UPSAMPLE_RATES),
                resblock_kernel_sizes=tuple(
                    config.HIFIGAN_RESBLOCK_KERNEL_SIZES),
                resblock_dilation_sizes=tuple(
                    tuple(d) for d in config.HIFIGAN_RESBLOCK_DILATION_SIZES),
                lrelu_slope=config.LRELU_SLOPE)
        elif config.MODEL == 'vocos':
            self.backbone = Vocos(
                features,
                config.GLOBAL_CHANNELS,
                channels=config.VOCOS_CHANNELS,
                pointwise_channels=config.VOCOS_POINTWISE_CHANNELS,
                num_layers=config.VOCOS_LAYERS,
                n_fft=config.NUM_FFT,
                hop_length=config.HOPSIZE)
        elif config.MODEL == 'fargan':
            # One more input channel: the pitch period
            self.backbone = FARGAN(
                features + 1, config.GLOBAL_CHANNELS,
                num_previous=config.NUM_PREVIOUS_SAMPLES)
        else:
            raise ValueError(f'Generator model {config.MODEL} is not defined')
        self.speaker_embedding = nn.Embedding(
            config.NUM_SPEAKERS, config.SPEAKER_CHANNELS)
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
        return_states=False
    ):
        """
        Arguments
            loudness: (B, F, T) full-band A-weighted loudness
            pitch: (B, T) pitch in Hz
            periodicity: (B, T)
            ppg: (B, PPG_CHANNELS, T)
            speakers: (B,) int speaker ids
            spectral_balance_ratios: (B,)
            loudness_ratios: (B,)
            initial_states / return_states: FARGAN's carry, for streaming
                that continues where the last call stopped
                (`models.fargan.FARGAN.forward`); other backbones ignore
                them

        Returns
            audio: (B, 1, T * HOPSIZE), float32 [, FARGAN's final carry]
        """
        features = self.prepare_features(loudness, pitch, periodicity, ppg)
        global_features = self.prepare_global_features(
            speakers, spectral_balance_ratios, loudness_ratios)
        if self.config.MODEL == 'fargan':
            out = self.backbone(
                features, global_features, self.dtype,
                initial_states=initial_states, return_states=return_states)
            if return_states:
                return out[0].transpose(1, 2), out[1]
            return out.transpose(1, 2)
        audio = self.backbone(features, global_features, self.dtype)
        return audio.transpose(1, 2)

    def prepare_global_features(
        self, speakers, spectral_balance_ratios, loudness_ratios
    ):
        """Speaker embedding ⊕ augmentation ratios, (B, 1, G)"""
        columns = [self.speaker_embedding(speakers).float()[:, None, :]]
        if self.config.AUGMENT_PITCH:
            columns.append(spectral_balance_ratios.float()[:, None, None])
        if self.config.AUGMENT_LOUDNESS:
            columns.append(loudness_ratios.float()[:, None, None])
        return torch.cat(columns, dim=-1).to(self.dtype)

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
                    distribution = self.pitch_distribution.to(hz.device)
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
