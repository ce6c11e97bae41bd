"""Generator: feature preparation + speaker conditioning + HiFi-GAN

Counterpart of `promonet_tpu/models/generator.py`, for the HiFi-GAN
backbone with a learned speaker table (not zero-shot). Public layouts
are the JAX package's: features (B, C, T) in, audio (B, 1, T * HOPSIZE)
out.
"""
import numpy as np
import torch
from torch import nn

from .. import config as config_module
from .. import load
from ..ops import sparse
from .hifigan import HiFiGAN


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
        if config.MODEL != 'hifigan' or config.ZERO_SHOT \
                or config.SPECTROGRAM_ONLY:
            raise NotImplementedError(
                'The port has the HiFi-GAN generator with a speaker table '
                'only')
        self.config = config
        self.dtype = (
            torch.bfloat16 if config.PRECISION == 'bfloat16'
            else torch.float32)
        if config.VARIABLE_PITCH_BINS:
            # A plain attribute, not a buffer: `.to(dtype)` must not round it
            self.pitch_distribution = torch.from_numpy(
                np.asarray(load.pitch_distribution(config), np.float32))
        self.backbone = HiFiGAN(
            config.NUM_FEATURES,
            config.GLOBAL_CHANNELS,
            initial_size=config.HIFIGAN_UPSAMPLE_INITIAL_SIZE,
            upsample_kernel_sizes=tuple(config.HIFIGAN_UPSAMPLE_KERNEL_SIZES),
            upsample_rates=tuple(config.HIFIGAN_UPSAMPLE_RATES),
            resblock_kernel_sizes=tuple(config.HIFIGAN_RESBLOCK_KERNEL_SIZES),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in config.HIFIGAN_RESBLOCK_DILATION_SIZES),
            lrelu_slope=config.LRELU_SLOPE)
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
        loudness_ratios
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

        Returns
            audio: (B, 1, T * HOPSIZE), float32
        """
        features = self.prepare_features(loudness, pitch, periodicity, ppg)
        global_features = self.prepare_global_features(
            speakers, spectral_balance_ratios, loudness_ratios)
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

        return torch.cat([c.to(self.dtype) for c in columns], dim=-1)
