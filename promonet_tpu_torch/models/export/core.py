"""Packed features and the exported packed-inference program

Counterpart of `promonet_tpu/models/export.py`. Features are packed into
one frame-rate tensor (B, len(labels()), T): band-averaged loudness,
pitch, periodicity, the sparsified PPG, and the speaker and the two
augmentation ratios repeated over the frames. `packed_inference` runs
the generator on such a tensor, and `from_file_to_file` exports that
program with `torch.export` beside its parameters.

The JAX package writes `<output_file>.stablehlo` (a `jax.export`
artefact) and `<output_file>.params` (an orbax checkpoint); the port
writes `<output_file>.pt2` (`torch.export.save`) and `<output_file>.pt`
(the generator's state dict, `utils.checkpoint`). `torch.export.load`
of the program needs `promonet_tpu_torch` imported in the process: the
program calls the residual-block operator that the package registers
(`ops.resblock.resblock_op`), and on the card its twelve Block calls are
that operator's kernel, with the weights packed once into the program as
constants (`models.hifigan.Block.freeze`).
"""
from pathlib import Path

import torch
from torch import nn

from ... import config as config_module
from ... import load
from ...ops import sparse
from ...utils import checkpoint as checkpoint_module
from ..generator import _band_average
from ..hifigan import Block


###############################################################################
# Packed features
###############################################################################


def labels(config=None):
    """The packed tensor's channel names, in order"""
    config = config_module.default() if config is None else config
    names = [f'loudness-{i}' for i in range(config.LOUDNESS_BANDS)]
    names += ['pitch', 'periodicity']
    names += [f'ppg-{i}' for i in range(config.PPG_CHANNELS)]
    names += ['speaker', 'spectral balance', 'loudness ratio']
    return names


def pack_features(
    loudness,
    pitch,
    periodicity,
    ppg,
    speakers,
    spectral_balance_ratios,
    loudness_ratios,
    config=None
):
    """Pack features into one (B, len(labels()), T) float32 tensor

    loudness (B, F, T) is averaged into LOUDNESS_BANDS bands and the PPG
    sparsified, as the generator does; the (B,) speakers and ratios are
    repeated over the T frames.
    """
    config = config_module.default() if config is None else config
    frames = loudness.shape[-1]
    averaged = _band_average(loudness, config.LOUDNESS_BANDS)
    ppg = sparse.sparsify(
        ppg, config.SPARSE_PPG_METHOD, config.SPARSE_PPG_THRESHOLD)

    def broadcast(x):
        return x.float()[:, None, None].expand(x.shape[0], 1, frames)

    return torch.cat(
        [
            averaged.float(),
            pitch[:, None].float(),
            periodicity[:, None].float(),
            ppg.float(),
            broadcast(speakers),
            broadcast(spectral_balance_ratios),
            broadcast(loudness_ratios)],
        dim=1)


def unpack_features(x, config=None):
    """The generator's inputs from a packed (B, C, T) tensor: loudness
    (B, LOUDNESS_BANDS, T), pitch, periodicity, ppg, int64 speakers and
    the two ratios of the first frame"""
    config = config_module.default() if config is None else config
    i = 0
    loudness = x[:, i:i + config.LOUDNESS_BANDS]
    i += config.LOUDNESS_BANDS
    pitch = x[:, i]
    i += 1
    periodicity = x[:, i]
    i += 1
    ppg = x[:, i:i + config.PPG_CHANNELS]
    i += config.PPG_CHANNELS
    speakers = x[:, i, 0].long()
    i += 1
    spectral_balance_ratios = x[:, i, 0]
    i += 1
    loudness_ratios = x[:, i, 0]
    return (
        loudness, pitch, periodicity, ppg, speakers, spectral_balance_ratios,
        loudness_ratios)


def packed_inference(generator, x):
    """Audio (B, 1, T * HOPSIZE) from packed features (B, C, T)

    The packed loudness is already band-averaged, so the generator's own
    band average over it keeps it (one band per row), and the PPG is
    sparsified a second time, as in the JAX package.
    """
    return generator(*unpack_features(x, generator.config))


class PackedInference(nn.Module):
    """`packed_inference` of a generator as a module, for `torch.export`"""

    def __init__(self, generator):
        super().__init__()
        self.generator = generator

    def forward(self, x):
        return packed_inference(self.generator, x)


###############################################################################
# Export
###############################################################################


def from_file_to_file(
    checkpoint, output_file, buffer_size=8192, config=None, device='cuda'
):
    """Export the packed-inference program of a generator checkpoint

    The generator (`load.generator`, in config.PRECISION: bf16 by
    default) is built on `device` and checked on a (1, C, buffer_size //
    HOPSIZE) zero input, which must give (1, 1, buffer_size) float32
    audio; then the program is exported at that shape to
    `<output_file>.pt2` and the generator's parameters saved to
    `<output_file>.pt`. Returns output_file.
    """
    config = config_module.default() if config is None else config
    generator = load.generator(checkpoint, config, device)
    for module in generator.modules():
        if isinstance(module, Block):
            module.freeze()
    program = PackedInference(generator).eval()
    frames = buffer_size // config.HOPSIZE
    x = torch.zeros(
        (1, len(labels(config)), frames), dtype=torch.float32,
        device=next(generator.parameters()).device)

    with torch.inference_mode():
        y = program(x)
    assert y.shape == (1, 1, buffer_size) and y.dtype == torch.float32

    output_file = Path(output_file)
    output_file.parent.mkdir(parents=True, exist_ok=True)
    exported = torch.export.export(program, (x,))
    torch.export.save(exported, output_file.with_suffix('.pt2'))
    checkpoint_module.save(
        output_file.with_suffix('.pt'), generator.state_dict())
    return output_file
