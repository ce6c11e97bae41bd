"""The GAN training step of the reference

Frozen copies at commit ce32675 of `promonet_tpu_torch/models/
discriminator.py` (`WNConv2d`, `DiscriminatorP`, `DiscriminatorCMB` and
the multi-period plus complex multi-band set of `Discriminator`),
`train/loss.py` (feature matching, least-squares adversarial losses,
the mel loss), `models/modules.py` (`weight_norm`, `normed`, `split`,
`materialize`) and `train/core.py` (`build_optimizer`'s AdamW and
`train_step`: the discriminators' step against the detached output,
then the generator's step through the updated discriminators). The
generator is `models.Generator`, trained as (v, g) pairs for each
weight-normed weight. Float32 with TF32 off, or with every operand and
result through `precision.Float8` (the control).
"""
import torch
import torch.nn.functional as F
from torch import nn

from . import dsp
from .models import leaky_relu
from .precision import EXACT


def norm(weight, axes):
    return torch.sqrt(
        torch.sum(torch.square(weight), dim=axes, keepdim=True) + 1e-12)


def weight_norm(v, g, axes):
    return v * (g / norm(v, axes))


def normed(module):
    """{weight name: norm axes} of the module's weight-normed weights"""
    return {
        f'{prefix}.weight' if prefix else 'weight': submodule.norm_axes
        for prefix, submodule in module.named_modules()
        if getattr(submodule, 'norm_axes', None)}


def split(state, axes_by_name):
    """Trainable leaves: each weight-normed weight as (v, g = ||v||)"""
    trainable = {}
    for name, value in state.items():
        if name in axes_by_name:
            trainable[f'{name}_v'] = value
            trainable[f'{name}_g'] = norm(value, axes_by_name[name])
        else:
            trainable[name] = value
    return trainable


def materialize(trainable, axes_by_name):
    state = {}
    for name, value in trainable.items():
        if name.endswith('_g') and name[:-2] in axes_by_name:
            continue
        if name.endswith('_v') and name[:-2] in axes_by_name:
            name = name[:-2]
            value = weight_norm(
                value, trainable[f'{name}_g'], axes_by_name[name])
        state[name] = value
    return state


###############################################################################
# Discriminators (models/discriminator.py)
###############################################################################


class WNConv2d(nn.Module):
    norm_axes = (1, 2, 3)

    def __init__(self, in_channels, out_channels, kernel_size, stride=(1, 1),
                 padding=(0, 0), precision=EXACT):
        super().__init__()
        self.stride, self.padding, self.precision = (
            tuple(stride), tuple(padding), precision)
        self.weight_v = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel_size))
        self.weight_g = nn.Parameter(torch.empty(out_channels, 1, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x):
        p = self.precision
        weight = weight_norm(self.weight_v, self.weight_g, self.norm_axes)
        y = p.result(F.conv2d(p.operand(x), p.operand(weight),
                              stride=self.stride, padding=self.padding))
        return y + self.bias[:, None, None]


class DiscriminatorP(nn.Module):
    def __init__(self, period, precision, kernel_size=5, stride=3,
                 slope=0.1):
        super().__init__()
        self.period, self.slope = period, slope
        pad = ((kernel_size - 1) // 2, 0)
        self.convs = nn.ModuleList(
            WNConv2d(cin, cout, (kernel_size, 1), (s, 1), pad, precision)
            for cin, cout, s in ((1, 32, stride), (32, 128, stride),
                                 (128, 512, stride), (512, 1024, stride),
                                 (1024, 1024, 1)))
        self.convs.append(WNConv2d(1024, 1, (3, 1), padding=(1, 0),
                                   precision=precision))

    def forward(self, x):
        batch, _, time = x.shape
        if time % self.period:
            x = F.pad(x, (0, self.period - time % self.period),
                      mode='reflect')
            time = x.shape[-1]
        x = x.reshape(batch, 1, time // self.period, self.period)
        maps = []
        for conv in self.convs[:-1]:
            x = leaky_relu(conv(x), self.slope)
            maps.append(x)
        x = self.convs[-1](x)
        maps.append(x)
        return x.reshape(batch, -1), maps


class DiscriminatorCMB(nn.Module):
    bands = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))

    def __init__(self, window_size, hopsize, precision, channels=32,
                 slope=0.1):
        super().__init__()
        self.window_size, self.hopsize, self.slope = (
            window_size, hopsize, slope)
        self.convs = nn.ModuleList()
        for _ in self.bands:
            for i, (kernel, stride, padding) in enumerate((
                ((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)),
                ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
                ((3, 3), (1, 1), (1, 1)),
            )):
                self.convs.append(WNConv2d(
                    1 if i == 0 else channels, channels, kernel, stride,
                    padding, precision))
        self.convs.append(WNConv2d(channels, 1, (3, 3), padding=(1, 1),
                                   precision=precision))

    def forward(self, x):
        x = dsp.reflect_pad(x, (self.window_size - self.hopsize) // 2)
        frames = x[:, 0].unfold(-1, self.window_size, self.hopsize)
        magnitude = torch.abs(torch.fft.rfft(frames, n=self.window_size))
        magnitude = magnitude[:, None]
        bins = self.window_size // 2 + 1
        maps, outputs = [], []
        layers = len(self.convs) // len(self.bands)
        for i, (low, high) in enumerate(self.bands):
            band = magnitude[..., int(low * bins):int(high * bins)]
            for conv in self.convs[i * layers:(i + 1) * layers]:
                band = leaky_relu(conv(band), self.slope)
                maps.append(band)
            outputs.append(band)
        x = self.convs[-1](torch.cat(outputs, dim=-1))
        maps.append(x)
        return x.reshape(x.shape[0], -1), maps


class Discriminator(nn.Module):
    """Multi-period (2, 3, 5, 7, 11) and complex multi-band"""

    def __init__(self, config, precision=EXACT):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorP(period, precision, slope=config.LRELU_SLOPE)
             for period in (2, 3, 5, 7, 11)] +
            [DiscriminatorCMB(config.WINDOW_SIZE, config.HOPSIZE, precision,
                              slope=config.LRELU_SLOPE)])

    def forward(self, real, fake):
        out = [], [], [], []
        for discriminator in self.discriminators:
            logit_real, maps_real = _call(discriminator, real)
            logit_fake, maps_fake = _call(discriminator, fake)
            for items, item in zip(
                    out, (logit_real, logit_fake, maps_real, maps_fake)):
                items.append(item)
        return out


def _call(discriminator, audio):
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            discriminator, audio, use_reentrant=False)
    return discriminator(audio)


###############################################################################
# Losses (train/loss.py) and the step (train/core.py)
###############################################################################


def mel_loss(spectrograms, generated, config):
    """Mean |log-mels of the target magnitudes - log-mels of the audio|"""
    audio = dsp.reflect_pad(
        generated[:, 0], (config.NUM_FFT - config.HOPSIZE) // 2)
    magnitude = dsp.stft_magnitude(audio, config.NUM_FFT, config.HOPSIZE,
                                   1e-6)
    return torch.mean(torch.abs(
        dsp.log_mels(spectrograms, config, EXACT) -
        dsp.log_mels(magnitude, config, EXACT)))


def optimizer(parameters, config):
    spec = dict(config.OPTIMIZER)
    if spec.get('name', 'adamw') != 'adamw':
        raise ValueError('the reference trains with AdamW only')
    return torch.optim.AdamW(
        parameters, lr=spec.get('lr', 2e-4),
        betas=(spec.get('b1', .8), spec.get('b2', .99)),
        eps=spec.get('eps', 1e-9), weight_decay=spec.get('weight_decay', 1e-2))


class Trainer:
    """The reference's training state and step

    generator: `models.Generator`; discriminator: `Discriminator`; both
    loaded with the harness's state dicts. `trainable` is the
    generator's leaves by the port's names ((v, g) pairs).
    """

    def __init__(self, generator, discriminator, config):
        self.config = config
        self.generator, self.discriminator = generator, discriminator
        self.axes = normed(generator)
        self.trainable = {
            name: value.detach().clone().requires_grad_()
            for name, value in split(
                dict(generator.named_parameters()), self.axes).items()}
        self.names = sorted(self.trainable)
        self.generator_optimizer = optimizer(
            [self.trainable[name] for name in self.names], config)
        self.discriminator_optimizer = optimizer(
            list(discriminator.parameters()), config)

    def step(self, batch):
        """One step; returns (generated audio, generator total, discriminator
        total)"""
        config = self.config
        generated = torch.func.functional_call(
            self.generator, materialize(self.trainable, self.axes),
            (batch['loudness'], batch['pitch'], batch['periodicity'],
             batch['ppg'], batch['speakers'],
             batch['spectral_balance_ratios'], batch['loudness_ratios']))
        audio = batch['audio']

        real, fake, _, _ = self.discriminator(audio, generated.detach())
        discriminator_total = sum(
            torch.mean((1. - r) ** 2) + torch.mean(f ** 2)
            for r, f in zip(real, fake))
        parameters = list(self.discriminator.parameters())
        _apply(self.discriminator_optimizer, parameters,
               torch.autograd.grad(discriminator_total, parameters,
                                   allow_unused=True))

        total = config.MEL_LOSS_WEIGHT * mel_loss(
            batch['spectrograms'], generated, config)
        _, fake, real_maps, fake_maps = self.discriminator(audio, generated)
        for reals, fakes in zip(real_maps, fake_maps):
            for r, f in zip(reals, fakes):
                total = total + config.FEATURE_MATCHING_LOSS_WEIGHT * \
                    torch.mean(torch.abs(r.detach() - f))
        total = total + config.ADVERSARIAL_LOSS_WEIGHT * sum(
            torch.mean((1. - f) ** 2) for f in fake)
        parameters = [self.trainable[name] for name in self.names]
        _apply(self.generator_optimizer, parameters,
               torch.autograd.grad(total, parameters, allow_unused=True))
        return generated.detach(), total.detach(), \
            discriminator_total.detach()


def _apply(optimizer, parameters, gradients):
    for parameter, gradient in zip(parameters, gradients):
        parameter.grad = torch.zeros_like(parameter) if gradient is None \
            else gradient
    optimizer.step()
    for parameter in parameters:
        parameter.grad = None
