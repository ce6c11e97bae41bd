"""Speech synthesis (counterpart of `promonet_tpu/synthesize/core.py`)

`from_features` and `generate` follow the JAX package's exact-length
path: features are zero-padded to a bucketed frame count, the generator
runs over the bucket, and the audio is trimmed to frames * HOPSIZE
samples. `from_features_batched` runs utterances of one bucket together,
padded by replicating their last frame, and returns the bucket's audio
untrimmed. `from_edited_audio` is the whole editing chain in one call,
with every intermediate left on the device at its bucket's length. The
`from_file*` functions read features from disk and write wav files.
"""
import numpy as np
import torch

from .. import convert
from .. import device as device_module
from .. import edit as edit_module
from .. import load
from .. import preprocess as preprocess_module
from ..data import bucket_frames
from ..ops import grid as grid_ops
from ..utils import audio as audio_module


def from_features(
    loudness,
    pitch,
    periodicity,
    ppg,
    generator,
    speaker=0,
    spectral_balance_ratio=1.,
    loudness_ratio=1.,
    output_dtype='float32',
    device='cuda'
):
    """Synthesize speech

    Arguments
        loudness: (F, T) loudness contour
        pitch: (1, T) pitch contour in Hz
        periodicity: (1, T) periodicity contour
        ppg: (C, T) phonetic posteriorgram
        generator: `models.Generator` with its weights, on `device`
        speaker: integer speaker id
        spectral_balance_ratio: (0, 2] spectral balance / formant ratio
        loudness_ratio: loudness ratio
        output_dtype: 'float32', or 'int16' for the PCM16 wire format
        device: where to run; 'cuda' raises on a host without a card

    Returns
        audio: (1, T * HOPSIZE) numpy array
    """
    return generate(
        loudness, pitch, periodicity, ppg, generator, speaker,
        spectral_balance_ratio, loudness_ratio, device, output_dtype)


def from_file(
    loudness_file,
    pitch_file,
    periodicity_file,
    ppg_file,
    generator,
    speaker=0,
    spectral_balance_ratio=1.,
    loudness_ratio=1.,
    device='cuda'
):
    """Synthesize from features on disk

    The PPG is resampled to the pitch's frame count (`load.ppg`), on
    `device`.

    Returns
        audio: (1, T * HOPSIZE) numpy array
    """
    config = generator.config
    pitch = load.array(pitch_file)
    return from_features(
        load.array(loudness_file),
        pitch,
        load.array(periodicity_file),
        load.ppg(ppg_file, pitch.shape[-1], config, device),
        generator,
        speaker,
        spectral_balance_ratio,
        loudness_ratio,
        device=device)


def from_file_to_file(
    loudness_file,
    pitch_file,
    periodicity_file,
    ppg_file,
    output_file,
    generator,
    speaker=0,
    spectral_balance_ratio=1.,
    loudness_ratio=1.,
    device='cuda'
):
    """Synthesize from features on disk and save a 16-bit wav file"""
    audio = from_file(
        loudness_file, pitch_file, periodicity_file, ppg_file, generator,
        speaker, spectral_balance_ratio, loudness_ratio, device)
    audio_module.save(output_file, audio, generator.config.SAMPLE_RATE)


def from_files_to_files(
    loudness_files,
    pitch_files,
    periodicity_files,
    ppg_files,
    output_files,
    generator,
    speakers=None,
    spectral_balance_ratio=1.,
    loudness_ratio=1.,
    device='cuda'
):
    """Synthesize several utterances from disk, one after another"""
    if speakers is None:
        speakers = [0] * len(loudness_files)
    for *files, speaker in zip(
        loudness_files, pitch_files, periodicity_files, ppg_files,
        output_files, speakers
    ):
        from_file_to_file(
            *files, generator, speaker=speaker,
            spectral_balance_ratio=spectral_balance_ratio,
            loudness_ratio=loudness_ratio, device=device)


def from_features_batched(
    feature_sets,
    generator,
    speakers=None,
    spectral_balance_ratios=None,
    loudness_ratios=None,
    batch_size=8,
    device='cuda'
):
    """Synthesize utterances of one frame bucket, `batch_size` per call

    Each feature is padded to its bucket by replicating its last frame
    (not with zeros, as `generate` pads), so log-domain consumers never
    see a zero pitch. A group short of `batch_size` is filled by
    repeating its rows, so every generator call has `batch_size` rows.
    NaN pitch becomes 100 Hz.

    Arguments
        feature_sets: list of (loudness, pitch, periodicity, ppg), numpy
            arrays or tensors at their true lengths, in the layouts of
            `from_features`; all must fall in one bucket
        generator: `models.Generator` with its weights, on `device`
        speakers / spectral_balance_ratios / loudness_ratios: one per set;
            None gives 0 / 1. / 1.

    Returns
        audio: (len(feature_sets), 1, bucket * HOPSIZE) float32 tensor on
        `device`, untrimmed
    """
    device = device_module.resolve(device)
    config = generator.config
    count = len(feature_sets)
    if speakers is None:
        speakers = [0] * count
    if spectral_balance_ratios is None:
        spectral_balance_ratios = [1.] * count
    if loudness_ratios is None:
        loudness_ratios = [1.] * count

    sets = [
        tuple(_replicate_to_bucket(value, config, device) for value in values)
        for values in feature_sets]
    buckets = {values[1].shape[-1] for values in sets}
    if len(buckets) != 1:
        raise ValueError(f'feature sets span buckets {sorted(buckets)}')

    outputs = []
    with torch.no_grad():
        for start in range(0, count, batch_size):
            group = sets[start:start + batch_size]
            rows = [i % len(group) for i in range(batch_size)]

            def stack(index):
                return torch.stack([group[row][index] for row in rows])

            def per_row(values, dtype):
                return torch.tensor(
                    [values[start + row] for row in rows], dtype=dtype,
                    device=device)

            audio = generator(
                stack(0),
                torch.nan_to_num(stack(1).reshape(batch_size, -1), nan=100.),
                stack(2).reshape(batch_size, -1),
                stack(3),
                per_row(speakers, torch.long),
                per_row(spectral_balance_ratios, torch.float32),
                per_row(loudness_ratios, torch.float32))
            outputs.append(audio[:len(group)])
    return outputs[0] if len(outputs) == 1 else torch.cat(outputs)


def _replicate_to_bucket(value, config, device):
    """A float32 feature on `device`, its last frame repeated to the bucket"""
    value = torch.as_tensor(np.asarray(value, np.float32)) \
        if not isinstance(value, torch.Tensor) else value.float()
    value = value.to(device)
    pad = bucket_frames(
        value.shape[-1], config.INFERENCE_FRAME_BUCKETS) - value.shape[-1]
    if not pad:
        return value
    return torch.cat(
        (value, value[..., -1:].expand(*value.shape[:-1], pad)), -1)


def from_edited_audio(
    audio,
    pitch_model,
    ppg_model,
    generator,
    sample_rate=None,
    pitch_shift_cents=None,
    time_stretch_ratio=None,
    loudness_scale_db=None,
    stretch_unvoiced=True,
    stretch_silence=True,
    speaker=0,
    spectral_balance_ratio=1.,
    loudness_ratio=1.,
    output_dtype='float32',
    device='cuda'
):
    """Audio in → edited audio out, in one call on the device

    Feature extraction, editing and the generator run on bucket-shaped
    tensors that never leave the device: the audio is padded to its
    input bucket, the features are resampled on the constant-rate grid
    arange(output bucket) * step, and only the first
    round(frames / ratio) * HOPSIZE samples come back. The PPG-aware
    stretch (`stretch_unvoiced` or `stretch_silence` False) needs the
    true-length PPG on the host for its grid and goes through
    `preprocess.from_audio` → `edit.from_features` → `from_features`.

    Arguments
        audio: (1, T) numpy waveform; int16 is taken as PCM and scaled
            by 1 / 32768 on the device
        pitch_model, ppg_model: the extractors' models, on `device`
        generator: `models.Generator` with its weights, on `device`
        sample_rate: rate of `audio`; another rate than SAMPLE_RATE is
            resampled on the host first
        the edit amounts of `edit.from_features` and the speaker and
        ratios of `from_features`

    Returns
        audio: (1, round(T // HOPSIZE / ratio) * HOPSIZE) numpy array
    """
    device = device_module.resolve(device)
    config = generator.config
    audio = np.asarray(audio)
    resampled = sample_rate is not None and sample_rate != config.SAMPLE_RATE
    selective = time_stretch_ratio is not None and not (
        stretch_unvoiced and stretch_silence)
    if audio.dtype == np.int16 and (resampled or selective):
        # Only the one-call path at the native rate takes PCM to the card
        audio = audio / np.float32(32768.)
    if resampled:
        audio = audio_module.resample(audio, sample_rate, config.SAMPLE_RATE)

    if selective:
        features = preprocess_module.from_audio(
            audio, pitch_model, ppg_model, loudness_bands=None, config=config,
            device=device)
        edited = edit_module.from_features(
            *features,
            pitch_shift_cents=pitch_shift_cents,
            time_stretch_ratio=time_stretch_ratio,
            loudness_scale_db=loudness_scale_db,
            stretch_unvoiced=stretch_unvoiced,
            stretch_silence=stretch_silence,
            config=config)
        return from_features(
            *edited,
            generator=generator,
            speaker=speaker,
            spectral_balance_ratio=spectral_balance_ratio,
            loudness_ratio=loudness_ratio,
            output_dtype=output_dtype,
            device=device)

    hopsize = config.HOPSIZE
    frames = audio.shape[-1] // hopsize
    bucket_in = bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS)
    ratio = 1. if time_stretch_ratio is None else time_stretch_ratio
    out_frames = int(round(frames / ratio))
    bucket_out = bucket_frames(out_frames, config.INFERENCE_FRAME_BUCKETS)

    # PCM crosses to the card as int16, half the bytes of float32
    samples = torch.from_numpy(audio[:, :bucket_in * hopsize]).to(device)
    padded = preprocess_module.core.pad(
        samples.float() / 32768. if samples.dtype == torch.int16 else samples,
        bucket_in * hopsize, device)
    features = preprocess_module.core.extract_padded(
        padded, pitch_model, ppg_model, preprocess_module.core.PADDED, None,
        config)

    # Per-output-frame step in input frames, in float32 as the grid is
    step = (frames - 1) / (out_frames - 1) if out_frames > 1 else 0.
    grid = torch.arange(bucket_out, dtype=torch.float32, device=device) * \
        torch.tensor(step, dtype=torch.float32, device=device)
    pitch = 2 ** grid_ops.sample(torch.log2(features['pitch']), grid)
    periodicity = grid_ops.sample(features['periodicity'], grid)
    loudness = grid_ops.sample(features['loudness'], grid) + torch.tensor(
        0. if loudness_scale_db is None else loudness_scale_db,
        dtype=torch.float32, device=device)
    ppg = grid_ops.sample(features['ppg'], grid, config.PPG_INTERP_METHOD)
    if pitch_shift_cents is not None:
        pitch = torch.clamp(
            pitch * torch.tensor(
                convert.cents_to_ratio(pitch_shift_cents),
                dtype=torch.float32, device=device),
            config.FMIN, config.FMAX)

    with torch.no_grad():
        output = generator(
            loudness[None],
            pitch,
            periodicity,
            ppg[None],
            torch.tensor([speaker], dtype=torch.long, device=device),
            torch.tensor([spectral_balance_ratio], device=device),
            torch.tensor([loudness_ratio], device=device))
    return _as_wire(
        output[0, :, :out_frames * hopsize], output_dtype).cpu().numpy()


def generate(
    loudness,
    pitch,
    periodicity,
    ppg,
    generator,
    speaker=0,
    spectral_balance_ratio=1.,
    loudness_ratio=1.,
    device='cuda',
    output_dtype='float32'
):
    """Generate speech with padding to bucketed lengths; numpy (1, samples)"""
    device = device_module.resolve(device)
    config = generator.config
    frames = pitch.shape[-1]
    bucket = bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS)

    def pad(x, nan=None):
        x = torch.as_tensor(np.asarray(x, np.float32)) \
            if not isinstance(x, torch.Tensor) else x.float()
        x = x.to(device)
        if nan is not None:
            x = torch.nan_to_num(x, nan=nan)
        return torch.nn.functional.pad(x, (0, bucket - x.shape[-1]))[None]

    with torch.no_grad():
        audio = generator(
            pad(loudness),
            pad(pitch.reshape(-1), nan=100.),
            pad(periodicity.reshape(-1)),
            pad(ppg),
            torch.tensor([speaker], dtype=torch.long, device=device),
            torch.tensor([spectral_balance_ratio], device=device),
            torch.tensor([loudness_ratio], device=device))
    return _as_wire(
        audio[0, :, :frames * config.HOPSIZE], output_dtype).cpu().numpy()


def _as_wire(audio, output_dtype):
    """Audio tensor as float32, or as 16-bit PCM for output_dtype 'int16'

    Converted on the device, so PCM halves the bytes copied to the host.
    """
    if output_dtype == 'int16':
        return torch.clamp(
            torch.round(audio.float() * 32767.), -32768., 32767.).to(
                torch.int16)
    return audio
