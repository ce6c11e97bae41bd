"""Loaders (counterpart of `promonet_tpu/load.py`)

Feature files are the JAX package's: `.npy` arrays, preferred, or
PyTorch `.pt` tensors, read with `torch.load(weights_only=True)`. Models
come from the port's own checkpoints or the JAX package's orbax ones
(`utils.checkpoint`, carried over by `models.bridge`): the generator from
a file, a run directory or an orbax directory; the pitch CNN, the PPG
encoder and the speaker encoder from config.CHECKPOINTS_DIR, else from
the checkpoints the JAX package ships (config.ASSETS_DIR / 'checkpoints'
/ <name>), which it reads by default. Where neither is found, each falls
back as the JAX package does (seeded weights, or no speaker encoder,
which leaves the spectral embedding) and says so on stderr; a checkpoint
that exists but cannot be read raises.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from . import config as config_module
from . import device as device_module
from .ops import grid
from .partition import core as partition_core
from .utils import audio as audio_module
from .utils import checkpoint as checkpoint_module


def array(file):
    """A feature array saved as .npy or .pt, as numpy

    A missing file whose .npy sibling exists is read from the sibling.
    """
    file = Path(file)
    npy = file.with_suffix('.npy')
    if file.suffix == '.npy' or (not file.exists() and npy.exists()):
        return np.load(npy if not file.exists() else file)
    if file.suffix == '.pt':
        return torch.load(
            file, map_location='cpu', weights_only=True).detach().numpy()
    raise FileNotFoundError(file)


def save_array(file, data):
    """Save a feature array: .pt as a tensor, anything else as .npy"""
    file = Path(file)
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    data = np.asarray(data)
    if file.suffix == '.pt':
        torch.save(torch.from_numpy(np.ascontiguousarray(data)), file)
    else:
        np.save(file.with_suffix('.npy'), data)


def audio(file, config=None):
    """A wav file as float32 numpy (1, T), mono, at config.SAMPLE_RATE"""
    config = config_module.default() if config is None else config
    return audio_module.load(file, config.SAMPLE_RATE)[0]


def features(prefix, config=None):
    """Loudness, pitch, periodicity and PPG saved under a file prefix

    Pitch and periodicity carry the '-viterbi' infix when
    config.VITERBI_DECODE_PITCH is set, as `preprocess.save` names them.
    """
    config = config_module.default() if config is None else config
    prefix = str(prefix)
    pitch_prefix = (
        f'{prefix}-viterbi' if config.VITERBI_DECODE_PITCH else prefix)
    return (
        array(f'{prefix}-loudness.npy'),
        array(f'{pitch_prefix}-pitch.npy'),
        array(f'{pitch_prefix}-periodicity.npy'),
        array(f'{prefix}-ppg.npy'))


def ppg(file, resample_length=None, config=None, device='cuda'):
    """A PPG file as a float32 tensor on `device`, maybe resampled to
    `resample_length` frames

    Resampling samples the grid of that length (config.PPG_INTERP_METHOD)
    and normalises each frame again in the log domain, so frames stay
    distributions. Both run on `device`.
    """
    config = config_module.default() if config is None else config
    values = torch.as_tensor(
        array(file), dtype=torch.float32,
        device=device_module.resolve(device))
    if resample_length is None or values.shape[-1] == resample_length:
        return values
    values = grid.sample(
        values, grid.of_length(values, resample_length),
        config.PPG_INTERP_METHOD)
    return torch.exp(
        torch.log(values + 1e-8) -
        torch.log(torch.sum(values + 1e-8, dim=-2, keepdim=True)))


def partition(dataset, adapt=None, config=None):
    """The partition of a dataset: {name: [stem, ...]}

    Read from config.PARTITIONS_DIR / ('adaptation' if adapt else
    'multispeaker') / '<dataset>.json', which `partition.dataset` and
    `data.synthetic.create` write. A published dataset without a
    partition of the port's own takes the shipped reference partition
    (`partition.core.published`), as the JAX package's partitioning
    does. adapt None takes config.ADAPTATION.
    """
    config = config_module.default() if config is None else config
    if adapt is None:
        adapt = config.ADAPTATION
    file = partition_core.path(dataset, adapt, config)
    if not file.exists():
        published = partition_core.published(dataset, adapt, config)
        if published is not None:
            return published
    with open(file) as handle:
        return json.load(handle)


def text(file):
    """The contents of a UTF-8 text file"""
    with open(file, encoding='utf-8') as handle:
        return handle.read()


def pitch_distribution(config=None, dataset=None, partition='train'):
    """Boundaries of the variable-width pitch bins, in Hz: PITCH_BINS
    quantiles of every voiced pitch frame of a dataset's partition

    dataset None takes config.TRAINING_DATASET. The file is named
    '<dataset>-<PITCH_BINS><key>.npy' ('-loudness', '-pitch' and
    '-viterbi' in the key as the configuration augments and decodes), and
    resolved in this order:
    1. the file the JAX package ships, config.ASSETS_DIR / 'stats', read
       only;
    2. the port's own, config.CACHE_DIR.parent / 'stats', which an
       earlier call wrote;
    3. else computed over the cached features (`_compute_pitch_distribution`)
       and written there, atomically.
    Where computing raises (no dataset on disk), log-uniform boundaries
    over [FMIN, FMAX], as the JAX function falls back. The result is kept
    for the process, keyed on the file: `convert` asks for it on every
    conversion.
    """
    config = config_module.default() if config is None else config
    if dataset is None:
        dataset = config.TRAINING_DATASET
    key = ''
    if config.AUGMENT_LOUDNESS:
        key += '-loudness'
    if config.AUGMENT_PITCH:
        key += '-pitch'
    if config.VITERBI_DECODE_PITCH:
        key += '-viterbi'
    name = f'{dataset}-{config.PITCH_BINS}{key}.npy'
    shipped = Path(config.ASSETS_DIR) / 'stats' / name
    file = Path(config.CACHE_DIR).parent / 'stats' / name
    cache = pitch_distribution.__dict__.setdefault('cache', {})
    cache_key = (str(shipped), str(file))
    if cache_key not in cache:
        if shipped.exists():
            cache[cache_key] = np.load(shipped)
        elif file.exists():
            cache[cache_key] = np.load(file)
        else:
            try:
                cache[cache_key] = _compute_pitch_distribution(
                    dataset, partition, config)
            except Exception:
                cache[cache_key] = np.exp(np.linspace(
                    np.log(config.FMIN), np.log(config.FMAX),
                    config.PITCH_BINS)).astype(np.float32)
            else:
                # Ranks of one data-parallel run may write it at once
                file.parent.mkdir(parents=True, exist_ok=True)
                partial = file.with_name(f'{file.name}.{os.getpid()}.tmp')
                with open(partial, 'wb') as handle:
                    np.save(handle, cache[cache_key])
                os.replace(partial, file)
    return cache[cache_key]


def _compute_pitch_distribution(dataset, partition, config):
    """The quantiles over every voiced frame of the partition's cached
    pitch (NaN-free, periodicity above VOICING_THRESHOLD), float32, as the
    JAX package computes them

    Raises where the dataset is not cached, or has no voiced frame.
    """
    from .data import Dataset

    if not (Path(config.CACHE_DIR) / dataset).is_dir():
        # Nothing to read: the partition's first stem would raise
        raise FileNotFoundError(Path(config.CACHE_DIR) / dataset)
    dataset_object = Dataset(dataset, partition, config)
    viterbi = '-viterbi' if config.VITERBI_DECODE_PITCH else ''
    voiced_pitch = []
    for stem in dataset_object.stems:
        pitch = array(dataset_object.cache / f'{stem}{viterbi}-pitch.npy')
        periodicity = array(
            dataset_object.cache / f'{stem}{viterbi}-periodicity.npy')
        voiced = np.logical_and(
            ~np.isnan(pitch), periodicity > config.VOICING_THRESHOLD)
        voiced_pitch.append(pitch[voiced])
    pitch = np.sort(np.concatenate(voiced_pitch))
    indices = np.linspace(
        len(pitch) / config.PITCH_BINS, len(pitch) - 1,
        config.PITCH_BINS).astype(np.int64)
    return pitch[indices].astype(np.float32)


def per_speaker_averages(dataset=None, partition='train', config=None):
    """Average voiced pitch of each speaker of a partition: {speaker: Hz}

    The geometric mean of the pitch of every frame whose periodicity is
    above config.VOICING_THRESHOLD, over the partition's stems (a train
    partition's augmented copies too). Read from config.CACHE_DIR.parent /
    'stats' / '<dataset>-<partition>-speaker-averages{-viterbi}.json',
    where an earlier call wrote it; the JAX package's file in its assets
    is neither read nor written.
    """
    from .data import Dataset

    config = config_module.default() if config is None else config
    if dataset is None:
        dataset = config.TRAINING_DATASET
    viterbi = '-viterbi' if config.VITERBI_DECODE_PITCH else ''
    file = (
        config.CACHE_DIR.parent / 'stats' /
        f'{dataset}-{partition}-speaker-averages{viterbi}.json')
    if file.exists():
        with open(file) as handle:
            return json.load(handle)

    dataset_object = Dataset(dataset, partition, config)
    pitches = {}
    for stem in dataset_object.stems:
        pitch = array(dataset_object.cache / f'{stem}{viterbi}-pitch.npy')
        periodicity = array(
            dataset_object.cache / f'{stem}{viterbi}-periodicity.npy')
        voiced = np.logical_and(
            ~np.isnan(pitch), periodicity > config.VOICING_THRESHOLD)
        pitches.setdefault(stem.split('/')[0], []).append(pitch[voiced])
    averages = {
        speaker: float(2 ** np.log2(np.concatenate(values)).mean())
        for speaker, values in pitches.items()}
    file.parent.mkdir(parents=True, exist_ok=True)
    with open(file, 'w') as handle:
        json.dump(averages, handle, indent=4, sort_keys=True)
    return averages


###############################################################################
# Models (each loader imports its model's module when called: the models
# import this module)
###############################################################################


def generator(checkpoint=None, config=None, device='cuda'):
    """A `models.Generator` (a `models.MelGenerator` under
    config.SPECTROGRAM_ONLY) with its weights, on `device`, in eval mode

    Resolved as the JAX package's `synthesize` resolves its generator:
    - `checkpoint` a file: its weights;
    - `checkpoint` an orbax directory (a JAX checkpoint, such as
      runs/promonet/release/generator-00155000): its weights, carried
      over by `models.bridge.generator_state_dict`;
    - `checkpoint` another directory (a run directory of either
      package): its newest readable `generator-*.pt` file or
      `generator-*` orbax directory (`utils.checkpoint.latest_path`);
    - None: config.DEFAULT_CHECKPOINT where set, else the newest
      checkpoint under RUNS_DIR / CONFIG if its weights fit the
      configuration; else weights seeded from 0, with a notice.
    """
    from .models import Generator, MelGenerator, init

    config = config_module.default() if config is None else config
    device = device_module.resolve(device)
    model = (MelGenerator if config.SPECTROGRAM_ONLY else Generator)(config)
    if checkpoint is None and config.DEFAULT_CHECKPOINT is not None:
        checkpoint = config.DEFAULT_CHECKPOINT
    if checkpoint is not None:
        model.load_state_dict(_generator_params(Path(checkpoint)))
        return model.to(device).eval()

    run = Path(config.RUNS_DIR) / config.CONFIG
    resolved = checkpoint_module.latest_path(run)
    if resolved is None:
        _notice(f'no generator checkpoint under {run}; using random init')
        return init.seeded(model, 0).to(device).eval()
    params = checkpoint_module.load(resolved)['params']
    if checkpoint_module.is_orbax(resolved):
        from .models import bridge

        try:
            params = bridge.generator_state_dict(params)
        except (KeyError, ValueError):
            # Another model's tree: it does not fit, as below
            params = {}
    expected = model.state_dict()
    if set(params) != set(expected) or any(
            params[name].shape != value.shape
            for name, value in expected.items()):
        _notice(
            f'default checkpoint {resolved} does not match the active '
            'configuration (load its config, e.g. '
            'PROMONET_TPU_TORCH_CONFIG=<run>/<config>.py); using random '
            'init')
        return init.seeded(model, 0).to(device).eval()
    model.load_state_dict(params)
    return model.to(device).eval()


def pitch_model(path=None, config=None, device='cuda'):
    """The pitch CNN with its weights, on `device`, in eval mode

    path None takes the newest `pitch-*.pt` in config.CHECKPOINTS_DIR,
    else the shipped orbax checkpoint (config.ASSETS_DIR / 'checkpoints'
    / 'pitch'); without either, weights seeded from 0, with a notice.
    `path` may name a `.pt` file or an orbax directory. The checkpoint's
    calibrated voicing threshold is kept on the model.
    """
    from .preprocess import PitchCNN

    config = config_module.default() if config is None else config
    model = PitchCNN()
    payload = _payload(path, config, 'pitch', 'using random init')
    if payload is not None and 'voicing_threshold' in payload:
        model.voicing_threshold = float(payload['voicing_threshold'])
    return _with_weights(model, payload, device)


def ppg_model(path=None, config=None, device='cuda'):
    """The PPG encoder with its weights, on `device`, in eval mode

    path None takes the newest `ppg-*.pt` in config.CHECKPOINTS_DIR,
    else the shipped orbax checkpoint; without either, weights seeded
    from 0, with a notice. `path` may name an orbax directory.
    """
    from .preprocess import PPGEncoder

    config = config_module.default() if config is None else config
    model = PPGEncoder(
        num_mels=config.NUM_MELS, num_phonemes=config.PPG_CHANNELS)
    return _with_weights(
        model, _payload(path, config, 'ppg', 'using random init'), device)


def speaker_encoder(path=None, config=None, device='cuda'):
    """The speaker encoder with its weights, on `device`, in eval mode

    path None takes, as the JAX package resolves it, the WavLM-Base+
    x-vector model where config.CHECKPOINTS_DIR holds its state dict
    (`wavlm_checkpoint`; a `models.wavlm.WavLMXVector` computing in
    PRECISION), else the newest `speaker-*.pt` there, else the shipped
    orbax checkpoint; without any, None, with a notice:
    `preprocess.speaker.from_audio` then takes the spectral embedding.
    `path` may name a WavLM checkpoint, a `speaker-*.pt` file or an orbax
    directory.
    """
    from .preprocess import SpeakerEncoder

    config = config_module.default() if config is None else config
    if path is None:
        path = wavlm_checkpoint(config)
    if path is not None and Path(path).name.startswith('wavlm'):
        return wavlm_encoder(path, config, device)
    payload = _payload(
        path, config, 'speaker', 'using the spectral embedding')
    if payload is None:
        return None
    model = SpeakerEncoder(
        num_mels=config.NUM_MELS,
        embedding_channels=config.WAVLM_EMBEDDING_CHANNELS)
    return _with_weights(model, payload, device)


def wavlm_checkpoint(config=None):
    """The last, in name order, of config.CHECKPOINTS_DIR's `wavlm*`
    entries: a state dict of `transformers.WavLMForXVector` at the
    published widths (a `.pt` or `.bin` file), or a directory as
    `save_pretrained(..., safe_serialization=False)` writes it
    (`config.json` beside `pytorch_model.bin`); None where there is none"""
    config = config_module.default() if config is None else config
    directory = Path(config.CHECKPOINTS_DIR)
    if not directory.is_dir():
        return None
    found = sorted(
        path for path in directory.glob('wavlm*')
        if path.suffix in ('.pt', '.bin') or
        (path / 'pytorch_model.bin').exists())
    return found[-1] if found else None


def wavlm_encoder(path, config=None, device='cuda'):
    """`models.wavlm.WavLMXVector` with the weights of a WavLM checkpoint
    (`wavlm_checkpoint`), on `device`, in eval mode, computing in
    PRECISION. A directory's `config.json` gives the sizes; a bare file
    is at the published widths."""
    from .models import wavlm

    config = config_module.default() if config is None else config
    path, values = Path(path), {}
    if path.is_dir():
        if (path / 'config.json').exists():
            values = json.loads((path / 'config.json').read_text())
        path = path / 'pytorch_model.bin'
    model = wavlm.WavLMXVector.from_config(
        values, torch.bfloat16 if config.PRECISION == 'bfloat16'
        else torch.float32)
    model.load_state_dict(wavlm_state_dict(
        torch.load(path, map_location='cpu', weights_only=True)))
    return model.to(device_module.resolve(device)).eval()


def wavlm_state_dict(state):
    """A `WavLMForXVector` state dict in the port's names: the positional
    convolution's weight norm as `weight_g`/`weight_v` (newer
    `transformers` save it as `parametrizations.weight.original0/1`), the
    speaker-classification head, its loss and the pre-training mask
    embedding left out"""
    renamed = {
        'parametrizations.weight.original0': 'weight_g',
        'parametrizations.weight.original1': 'weight_v'}
    out = {}
    for name, value in state.items():
        if name.startswith(('classifier.', 'objective.')) or \
                name == 'wavlm.masked_spec_embed':
            continue
        for old, new in renamed.items():
            name = name.replace(old, new)
        out[name] = value
    return out


def _generator_params(checkpoint):
    """The state dict of a generator checkpoint file, orbax directory or
    run directory (its newest checkpoint of either kind)"""
    if checkpoint.is_dir() and not checkpoint_module.is_orbax(checkpoint):
        resolved = checkpoint_module.latest_path(checkpoint)
        if resolved is None:
            raise FileNotFoundError(
                f'no readable generator-* checkpoint in {checkpoint}')
        checkpoint = resolved
    if checkpoint_module.is_orbax(checkpoint):
        from .models import bridge

        return bridge.generator_state_dict(
            checkpoint_module.load(checkpoint)['params'])
    return checkpoint_module.load(checkpoint)['params']


def _payload(path, config, prefix, fallback):
    """A checkpoint's payload, its 'params' a state dict: `path`, or the
    newest `<prefix>-*.pt` in config.CHECKPOINTS_DIR, or the shipped
    checkpoint config.ASSETS_DIR / 'checkpoints' / `prefix`; None, with a
    notice, where there is none"""
    if path is None:
        path = checkpoint_module.latest_path(
            config.CHECKPOINTS_DIR, f'{prefix}-*')
    if path is None:
        path = shipped_checkpoint(prefix, config)
    if path is None:
        _notice(
            f'no {prefix} checkpoint in {config.CHECKPOINTS_DIR} or '
            f'{Path(config.ASSETS_DIR) / "checkpoints"}; {fallback}')
        return None
    payload = checkpoint_module.load(path)
    if checkpoint_module.is_orbax(path):
        from .models import bridge

        state_dict = getattr(bridge, f'{prefix}_state_dict')
        payload = dict(payload, params=state_dict(payload['params']))
    return payload


def shipped_checkpoint(name, config=None):
    """The JAX package's shipped checkpoint of the pitch CNN, PPG encoder
    or speaker encoder (`name` 'pitch', 'ppg' or 'speaker'), where it
    exists: config.ASSETS_DIR / 'checkpoints' / `name`, as the JAX
    package's extractors find it; else None"""
    config = config_module.default() if config is None else config
    path = Path(config.ASSETS_DIR) / 'checkpoints' / name
    return path if path.exists() else None


def _with_weights(model, payload, device):
    """`model` with the payload's weights, or seeded from 0 without one"""
    from .models import init

    device = device_module.resolve(device)
    if payload is None:
        init.seeded(model, 0)
    else:
        model.load_state_dict(payload['params'])
    return model.to(device).eval()


def _notice(message):
    print(f'promonet_tpu_torch: {message}', file=sys.stderr)
