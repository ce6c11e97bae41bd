"""GAN and reconstruction losses (counterpart of `promonet_tpu/train/loss.py`)

Every loss is computed in float32, whatever the models' compute dtype.
"""
import torch
import torch.nn.functional as F

from ..ops import stft as stft_ops
from ..preprocess import spectrogram as spectrogram_module


###############################################################################
# Adversarial losses
###############################################################################


def feature_matching(real_feature_maps, fake_feature_maps, config):
    """Mean absolute difference of every feature map, the real ones
    detached; FEATURE_MATCHING_OMIT_FIRST drops each discriminator's first"""
    loss = 0.
    for real_maps, fake_maps in zip(real_feature_maps, fake_feature_maps):
        if config.FEATURE_MATCHING_OMIT_FIRST:
            real_maps, fake_maps = real_maps[1:], fake_maps[1:]
        for real, fake in zip(real_maps, fake_maps):
            loss = loss + torch.mean(torch.abs(
                real.detach().float() - fake.float()))
    return loss


def discriminator(real_outputs, fake_outputs, config):
    """(total, real losses, fake losses): least squares, or hinge under
    ADVERSARIAL_HINGE_LOSS"""
    real_losses, fake_losses = [], []
    for real_output, fake_output in zip(real_outputs, fake_outputs):
        real_output, fake_output = real_output.float(), fake_output.float()
        if config.ADVERSARIAL_HINGE_LOSS:
            real_losses.append(torch.mean(torch.relu(1. - real_output)))
            fake_losses.append(torch.mean(torch.relu(1. + fake_output)))
        else:
            real_losses.append(torch.mean((1. - real_output) ** 2))
            fake_losses.append(torch.mean(fake_output ** 2))
    return sum(real_losses) + sum(fake_losses), real_losses, fake_losses


def generator(discriminator_outputs, config):
    """(total, per-discriminator losses) of the generator's adversarial
    term"""
    if config.ADVERSARIAL_HINGE_LOSS:
        losses = [
            torch.mean(torch.relu(1. - output.float()))
            for output in discriminator_outputs]
    else:
        losses = [
            torch.mean((1. - output.float()) ** 2)
            for output in discriminator_outputs]
    return sum(losses), losses


###############################################################################
# Spectral losses
###############################################################################


def _stft_magnitude(x, fft_size, hop_size, win_length):
    """Root of the clamped magnitude of a centred Hann-window STFT"""
    window = stft_ops.hann_window(win_length, device=x.device)
    if win_length < fft_size:
        pad = (fft_size - win_length) // 2
        window = F.pad(window, (pad, fft_size - win_length - pad))
    magnitude = stft_ops.stft(
        x, fft_size, hop_size, window=window, center=True, magnitude=True)
    return torch.sqrt(torch.clamp(magnitude, min=1e-7))


def multi_resolution_spectral_convergence(
    x,
    y,
    fft_sizes=(2560, 1280, 640, 320, 160, 80),
    hop_sizes=(640, 320, 160, 80, 40, 20),
    win_lengths=(2560, 1280, 640, 320, 160, 80)
):
    """Spectral convergence averaged over six resolutions"""
    x = x.reshape(x.shape[0], -1).float()
    y = y.reshape(y.shape[0], -1).float()
    loss = 0.
    for fft_size, hop_size, win_length in zip(
        fft_sizes, hop_sizes, win_lengths
    ):
        x_magnitude = _stft_magnitude(x, fft_size, hop_size, win_length)
        y_magnitude = _stft_magnitude(y, fft_size, hop_size, win_length)
        loss = loss + (
            torch.sum(torch.abs(y_magnitude - x_magnitude)) /
            torch.clamp(torch.sum(torch.abs(y_magnitude)), min=1e-9))
    return loss / len(fft_sizes)


###############################################################################
# Time-domain loss
###############################################################################


def signal(y_true, y_pred):
    """Normalized-correlation waveform loss over (B, T)"""
    y_true, y_pred = y_true.float(), y_pred.float()
    t = y_true / (1e-15 + torch.linalg.norm(y_true, dim=-1, keepdim=True))
    p = y_pred / (1e-15 + torch.linalg.norm(y_pred, dim=-1, keepdim=True))
    return torch.mean(1. - torch.sum(p * t, dim=-1))


###############################################################################
# Mel reconstruction loss
###############################################################################


def mel(spectrograms, generated, config, mask=None):
    """L1 distance of the target linear spectrograms' log-mels and the
    generated audio's

    Arguments
        spectrograms: (B, n_freq, frames) target magnitudes
        generated: (B, 1, frames * HOPSIZE) audio
        mask: (..., frames) booleans, True where a frame counts; columns
            of bucket padding are left out, and set to 1 first so their
            log-mels stay finite
    """
    threshold = (
        config.LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD
        if config.SPARSE_MEL_LOSS else None)
    if mask is not None:
        spectrograms = torch.where(
            mask[..., None, :], spectrograms,
            torch.ones((), dtype=spectrograms.dtype,
                       device=spectrograms.device))
    mels = spectrogram_module.linear_to_mel(
        spectrograms.float(), config, threshold)
    generated_mels = spectrogram_module.from_audio(
        generated.float(), config, True, threshold)
    if config.SPARSE_MEL_LOSS:
        mels = mels + config.LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD
        generated_mels = (
            generated_mels + config.LOG_DYNAMIC_RANGE_COMPRESSION_THRESHOLD)
    difference = torch.abs(mels - generated_mels)
    if mask is None:
        return torch.mean(difference)
    weights = torch.broadcast_to(
        mask[..., None, :], difference.shape).to(difference.dtype)
    return torch.sum(difference * weights) / torch.clamp(
        torch.sum(weights), min=1.)
