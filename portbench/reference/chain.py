"""The edit chain of the reference: preprocess, Viterbi decode, edit,
synthesize

Frozen copies at commit ce32675 of the plain paths of
`promonet_tpu_torch/preprocess/core.py` (`from_audio`: bucket padding,
`extract_padded`), `preprocess/pitch.py` (`_frames`,
`cnn_posteriorgram`, `decode` with the Viterbi decoder, no
interpolation), `ops/viterbi.py` (`triangular_transition`,
`forward_plain`, `backtrace_plain`), `edit/core.py` (`from_features`,
constant-ratio stretch), `synthesize/core.py` (`generate`: zero padding
to the bucket; `from_features_batched`: last-frame padding, rows filled
by repetition) and `data/collate.py` (`bucket_frames`). `path_score`
is the reference's own: the log-probability of a state path under the
reference's observations, by which the program's decoded path is
judged.
"""
import numpy as np
import torch

from . import dsp

CANDIDATES = 256
TRANSITION_WIDTH = 9.
FRAME_SIZE = 1024


def bucket_frames(frames, buckets):
    """Smallest bucket of the ladder that fits `frames`, else `frames`"""
    for bucket in buckets:
        if frames <= bucket:
            return bucket
    return frames


###############################################################################
# Preprocess
###############################################################################


def frames_of(samples, hopsize, size=FRAME_SIZE):
    """Frames (frames, size) centered at (i + 0.5) * hopsize, zero-padded"""
    num_frames = samples.shape[-1] // hopsize
    centers = (np.arange(num_frames) + 0.5) * hopsize
    starts = np.round(centers - size / 2).astype(np.int64)
    pad_left = max(0, -int(starts.min()))
    pad_right = max(0, int(starts.max()) + size - samples.shape[-1])
    padded = torch.nn.functional.pad(samples, (pad_left, pad_right))
    index = (starts + pad_left)[:, None] + np.arange(size)[None]
    return padded[torch.from_numpy(index).to(padded.device)]


def pitch_logits(pitch_model, audio, hopsize):
    """CNN logits (frames, CANDIDATES) of audio (1, T), frames
    normalized to zero mean and unit population deviation"""
    frames = frames_of(audio[0], hopsize)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = frames / torch.clamp(
        frames.std(dim=-1, unbiased=False, keepdim=True), min=1e-6)
    return pitch_model(frames)


def log_frequencies(config, device):
    return torch.log(torch.from_numpy(np.exp(np.linspace(
        np.log(config.FMIN), np.log(config.FMAX), CANDIDATES)).astype(
            np.float32)).to(device))


def transition(device):
    """Log triangular transition (N, N), -1e30 outside the band"""
    index = np.arange(CANDIDATES)
    tri = np.maximum(
        0., TRANSITION_WIDTH - np.abs(index[:, None] - index[None, :]))
    tri = tri / tri.sum(axis=1, keepdims=True)
    log = np.where(tri > 0, np.log(np.maximum(tri, 1e-12)), -1e30)
    return torch.from_numpy(log).float().to(device)


def initial(device):
    return torch.full((CANDIDATES,), -float(np.log(np.float32(CANDIDATES))),
                      device=device)


def viterbi(observation):
    """Most likely path (T,) int64 of log-probabilities (T, N); ties
    go to the first index"""
    trans = transition(observation.device)
    num_frames = observation.shape[0]
    indices = torch.zeros((num_frames, CANDIDATES), dtype=torch.int64,
                          device=observation.device)
    alpha = initial(observation.device) + observation[0]
    for t in range(1, num_frames):
        best, arg = torch.max(alpha[:, None] + trans, dim=0)
        indices[t] = arg
        alpha = best + observation[t]
    indices = indices.cpu().numpy()
    path = np.empty(num_frames, np.int64)
    path[-1] = int(torch.argmax(alpha))
    for t in range(num_frames - 1, 0, -1):
        path[t - 1] = indices[t, path[t]]
    return torch.from_numpy(path).to(observation.device)


def path_score(observation, path):
    """Log-probability of `path` (T,) under observation (T, N), the
    triangular transition and the uniform start"""
    path = path.long().to(observation.device)
    trans = transition(observation.device)
    score = initial(observation.device)[path[0]] + \
        observation.gather(1, path[:, None]).sum()
    return float(score + trans[path[:-1], path[1:]].sum())


def refine(logits, bins, config):
    """Pitch (T,) in Hz, the posterior-weighted mean log frequency over
    bin ± 4, and periodicity (T,), the posterior mass at each bin"""
    log_freqs = log_frequencies(config, logits.device)
    neighbors = torch.clamp(
        bins[:, None] + torch.arange(-4, 5, device=logits.device), 0,
        CANDIDATES - 1)
    weights = torch.softmax(torch.gather(logits, 1, neighbors), dim=-1)
    pitch = torch.exp(torch.sum(weights * log_freqs[neighbors], dim=-1))
    periodicity = torch.softmax(logits, dim=-1).gather(
        1, bins[:, None])[:, 0]
    return pitch, periodicity


def preprocess(audio, pitch_model, ppg_model, config, precision):
    """The features of audio (1, T) (a float32 tensor on the device), as
    `preprocess.from_audio` computes them with the default features and
    LOUDNESS_BANDS bands: on audio zero-padded to its frame bucket,
    trimmed to T // HOPSIZE frames

    Returns {name: tensor}: loudness (bands, T'), pitch (1, T'),
    periodicity (1, T'), ppg (PPG_CHANNELS, T'), the padded frames'
    observation (frames, N) and decoded `path` (frames,).
    """
    frames = audio.shape[-1] // config.HOPSIZE
    samples = bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS) * \
        config.HOPSIZE
    audio = precision.operand(audio[:, :samples])
    audio = torch.nn.functional.pad(audio, (0, samples - audio.shape[-1]))
    loudness = dsp.band_average(
        dsp.loudness(audio, config), config.LOUDNESS_BANDS)
    logits = pitch_logits(pitch_model, audio, config.HOPSIZE)
    observation = precision.operand(torch.log_softmax(logits, dim=-1))
    path = viterbi(observation)
    pitch, periodicity = refine(precision.operand(logits), path, config)
    mels = dsp.log_mels(dsp.spectrogram(audio, config), config, precision)
    ppg = torch.exp(ppg_model(mels.transpose(0, 1)[None])[0].transpose(0, 1))
    return {
        'loudness': loudness[..., :frames],
        'pitch': pitch[None, :frames],
        'periodicity': periodicity[None, :frames],
        'ppg': ppg[..., :frames],
        'observation': observation,
        'logits': logits,
        'path': path}


###############################################################################
# Edit and synthesize
###############################################################################


def edit(loudness, pitch, periodicity, ppg, pitch_shift_cents,
         time_stretch_ratio, loudness_scale_db, config, precision):
    """Constant-ratio stretch, pitch shift (clamped to [FMIN, FMAX]) and
    loudness scale of exact-length features"""
    loudness, pitch, periodicity, ppg = (
        precision.operand(x) for x in (loudness, pitch, periodicity, ppg))
    grid = dsp.constant_grid(pitch.shape[-1], time_stretch_ratio,
                             pitch.device)
    pitch = 2 ** dsp.grid_sample(torch.log2(pitch), grid)
    periodicity = dsp.grid_sample(periodicity, grid)
    loudness = dsp.grid_sample(loudness, grid)
    ppg = dsp.grid_sample(ppg, grid)
    shift = torch.tensor(2 ** (pitch_shift_cents / 1200), dtype=torch.float32,
                         device=pitch.device)
    pitch = torch.clamp(pitch * shift, config.FMIN, config.FMAX)
    loudness = loudness + torch.tensor(
        loudness_scale_db, dtype=torch.float32, device=loudness.device)
    return loudness, pitch, periodicity, ppg


def synthesize(generator, loudness, pitch, periodicity, ppg, speaker,
               config):
    """Audio (T' * HOPSIZE,) of exact-length features: zero-padded to the
    bucket (NaN pitch as 100 Hz), generated, trimmed"""
    frames = pitch.shape[-1]
    bucket = bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS)

    def pad(x):
        return torch.nn.functional.pad(x, (0, bucket - frames))[None]

    device = pitch.device
    audio = generator(
        pad(loudness), pad(torch.nan_to_num(pitch.reshape(-1), nan=100.)),
        pad(periodicity.reshape(-1)), pad(ppg),
        torch.tensor([speaker], device=device),
        torch.ones(1, device=device), torch.ones(1, device=device))
    return audio[0, 0, :frames * config.HOPSIZE]


def fargan_inputs(generator, loudness, pitch, periodicity, ppg, speaker,
                  config):
    """FARGAN's conditioning of each subframe of `synthesize`'s generator
    call (the bucket's frames), (frames * subframes, 2 * subframe_size),
    and where each subframe's pitch lookback reads in its sample history,
    (frames * subframes, subframe_size + 4)"""
    frames = pitch.shape[-1]
    bucket = bucket_frames(frames, config.INFERENCE_FRAME_BUCKETS)

    def pad(x):
        return torch.nn.functional.pad(x, (0, bucket - frames))[None]

    device = pitch.device
    features, global_features = generator.inputs(
        pad(loudness), pad(torch.nan_to_num(pitch.reshape(-1), nan=100.)),
        pad(periodicity.reshape(-1)), pad(ppg),
        torch.tensor([speaker], device=device), torch.ones(1, device=device),
        torch.ones(1, device=device))
    backbone = generator.backbone
    cond = backbone.conditioning_of(features, global_features)
    index = backbone.lookback_of(features)[0].repeat_interleave(
        backbone.subframes, 0)
    return cond.reshape(-1, cond.shape[-1]), index


def synthesize_batched(generator, feature_sets, speakers, config,
                       batch_size):
    """Audio (len(sets), bucket * HOPSIZE) of feature sets of one bucket:
    each feature's last frame repeated to the bucket, NaN pitch as 100 Hz,
    a group short of `batch_size` filled by repeating its rows"""
    def replicate(value):
        pad = bucket_frames(value.shape[-1], config.INFERENCE_FRAME_BUCKETS) \
            - value.shape[-1]
        return torch.cat(
            (value, value[..., -1:].expand(*value.shape[:-1], pad)), -1)

    sets = [tuple(replicate(value) for value in values)
            for values in feature_sets]
    outputs = []
    for start in range(0, len(sets), batch_size):
        group = sets[start:start + batch_size]
        rows = [i % len(group) for i in range(batch_size)]

        def stack(index):
            return torch.stack([group[row][index] for row in rows])

        device = group[0][1].device
        audio = generator(
            stack(0),
            torch.nan_to_num(stack(1).reshape(batch_size, -1), nan=100.),
            stack(2).reshape(batch_size, -1), stack(3),
            torch.tensor([speakers[start + row] for row in rows],
                         device=device),
            torch.ones(batch_size, device=device),
            torch.ones(batch_size, device=device))
        outputs.append(audio[:len(group), 0])
    return torch.cat(outputs)
