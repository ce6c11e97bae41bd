"""Device-resident training data (counterpart of
`promonet_tpu/data/resident.py`)

The host loader (`data.loader`) reads, crops and copies every batch:
about 22 MB per step at the default batch of 64 x 16384 samples, read
from the cache by host threads while the card waits for it. The whole
preprocessed training partition of a corpus is small next to the card's
memory, so it can instead be packed once on the host (`pack`), copied to
the card once (`to_device`), and each step's random crops gathered on
the card (`sample`, `crops`): the host then sends the card no data at
all while it trains.

Packing, per stem, padded to the partition's longest stem (the JAX
package's choices):
- audio as int16, the 16-bit PCM of the cache, bit-exact; scaled by
  1 / 32768 on the card;
- full-band loudness averaged to LOUDNESS_BANDS bands on the host; the
  generator's band averaging is the identity on an input that already
  has LOUDNESS_BANDS rows, so the values that reach the network do not
  change; a loudness-augmented stem reuses its original's loudness, as
  the host loader does;
- pitch, periodicity and PPG as float16 (within 1e-3 relative; about a
  cent of pitch);
- no spectrogram: the trainer computes the mel loss's target from the
  audio crop on the card (`preprocess.spectrogram.from_audio`), so it
  matches the crop exactly.

Stems shorter than one chunk are left out. Sampling draws the stem and
the start uniformly from a `torch.Generator` on the card, in place of the
loader's shuffled epochs. Validation keeps the host loader.
"""
import numpy as np
import torch

from .. import config as config_module
from .. import load
from .dataset import Dataset


def pack(name, partition='train', config=None):
    """A partition's preprocessed cache packed into host arrays: {'audio':
    int16 (N, samples), 'loudness': float16 (N, LOUDNESS_BANDS, frames),
    'pitch', 'periodicity': float16 (N, frames), 'ppg': float16 (N,
    PPG_CHANNELS, frames), 'lengths', 'speakers': int32 (N,),
    'spectral_balance_ratios', 'loudness_ratios': float32 (N,)}

    Raises ValueError under ZERO_SHOT: the resident corpus carries speaker
    ids, not x-vectors (train with RESIDENT_DATA = False there).
    """
    from scipy.io import wavfile

    config = config_module.default() if config is None else config
    if config.ZERO_SHOT:
        raise ValueError(
            'The resident corpus carries speaker ids, and a ZERO_SHOT '
            'generator takes x-vectors: set RESIDENT_DATA = False')
    dataset = Dataset(name, partition, config)
    cache = dataset.cache
    viterbi = dataset.viterbi
    hopsize = config.HOPSIZE
    chunk_frames = config.CHUNK_SIZE // hopsize
    bands = config.LOUDNESS_BANDS

    records = []
    for stem in dataset.stems:
        frames = load.array(
            cache / f'{stem}{viterbi}-pitch.npy').reshape(-1).shape[-1]
        if frames >= chunk_frames:
            records.append((stem, frames))
    if not records:
        raise RuntimeError(f'No stems of at least one chunk in {name}')

    max_frames = max(frames for _, frames in records)
    count = len(records)
    audio = np.zeros((count, max_frames * hopsize), np.int16)
    loudness = np.zeros((count, bands, max_frames), np.float16)
    pitch = np.zeros((count, max_frames), np.float16)
    periodicity = np.zeros((count, max_frames), np.float16)
    ppg = np.zeros((count, config.PPG_CHANNELS, max_frames), np.float16)
    lengths = np.zeros((count,), np.int32)
    speakers = np.zeros((count,), np.int32)
    spectral_balance_ratios = np.ones((count,), np.float32)
    loudness_ratios = np.ones((count,), np.float32)

    for i, (stem, frames) in enumerate(records):
        lengths[i] = frames
        _, pcm = wavfile.read(cache / f'{stem}.wav')
        if pcm.dtype != np.int16:
            pcm = (np.clip(pcm, -1., 1.) * 32767).astype(np.int16)
        audio[i, :frames * hopsize] = pcm[:frames * hopsize]

        base, ratio_pitch, ratio_loudness = dataset._parse_ratios(stem)
        spectral_balance_ratios[i] = ratio_pitch
        loudness_ratios[i] = ratio_loudness
        loudness_stem = base if ratio_loudness != 1. else stem
        full = np.load(
            cache / f'{loudness_stem}-loudness.npy').astype(np.float32)
        loudness[i, :, :frames] = _band_average(full, bands)[:, :frames]

        pitch[i, :frames] = load.array(
            cache / f'{stem}{viterbi}-pitch.npy').reshape(-1)[:frames]
        periodicity[i, :frames] = load.array(
            cache / f'{stem}{viterbi}-periodicity.npy').reshape(-1)[:frames]
        ppg[i, :, :frames] = load.ppg(
            cache / f'{stem}-ppg.npy', frames, config,
            'cpu').numpy()[:, :frames]

        speakers[i] = dataset.speaker_index.get(stem.split('/')[0], 0)

    return {
        'audio': audio,
        'loudness': loudness,
        'pitch': pitch,
        'periodicity': periodicity,
        'ppg': ppg,
        'lengths': lengths,
        'speakers': speakers,
        'spectral_balance_ratios': spectral_balance_ratios,
        'loudness_ratios': loudness_ratios}


def _band_average(loudness, bands):
    """The generator's band averaging, on the host"""
    step = loudness.shape[-2] / bands
    return np.stack([
        loudness[int(band * step):int((band + 1) * step)].mean(axis=-2)
        for band in range(bands)])


def shard(packed, rank=0, world=1):
    """This rank's rows of a packed corpus

    With world > 1 the stems are first cycled up to a multiple of world
    (stem i of the padding is stem i % N), then split into world
    contiguous blocks, and rank keeps block `rank`: the layout of the JAX
    package's PartitionSpec('data') over the stem axis, whose device d
    holds the d-th contiguous block.
    """
    if world == 1:
        return packed
    count = len(packed['lengths'])
    padded = -(-count // world) * world
    if padded != count:
        extra = np.arange(padded - count) % count
        packed = {
            key: np.concatenate([value, value[extra]])
            for key, value in packed.items()}
    size = padded // world
    return {
        key: value[rank * size:(rank + 1) * size]
        for key, value in packed.items()}


def to_device(packed, device, rank=0, world=1):
    """Copy a packed corpus (or, with world > 1, this rank's `shard` of
    it) to `device` once; returns {name: tensor}"""
    local = shard(packed, rank, world)
    nbytes = sum(value.nbytes for value in packed.values())
    message = (
        f'resident dataset: {len(packed["lengths"])} stems, '
        f'{nbytes / 1e9:.2f} GB → {device}')
    if world > 1:
        local_bytes = sum(value.nbytes for value in local.values())
        message += (
            f' (sharded over data={world}: rank {rank} holds '
            f'{len(local["lengths"])} stems, {local_bytes / 1e9:.2f} GB)')
    print(message, flush=True)
    return {
        key: torch.from_numpy(np.ascontiguousarray(value)).to(device)
        for key, value in local.items()}


def crops(data, rows, starts, chunk_frames):
    """The training batch of the crops of `chunk_frames` frames starting at
    frame `starts[i]` of stem `rows[i]`: one batched gather per array, on
    the corpus' device

    Returns the host loader's training batch without 'spectrograms' and
    the host-only fields: 'audio' float32 (B, 1, chunk_frames * hopsize)
    in [-1, 1), 'loudness' (B, bands, chunk_frames), 'pitch',
    'periodicity' (B, chunk_frames), 'ppg' (B, channels, chunk_frames),
    float32; 'speakers' int64; the two ratios float32.
    """
    device = data['pitch'].device
    rows = torch.as_tensor(rows, device=device).long()
    starts = torch.as_tensor(starts, device=device).long()
    hopsize = data['audio'].shape[-1] // data['pitch'].shape[-1]
    frames = starts[:, None] + torch.arange(chunk_frames, device=device)
    samples = starts[:, None] * hopsize + torch.arange(
        chunk_frames * hopsize, device=device)
    row = rows[:, None]

    def channels(name):
        index = torch.arange(data[name].shape[1], device=device)
        return data[name][row[..., None], index[None, :, None],
                          frames[:, None, :]].float()

    return {
        'audio': (data['audio'][row, samples].float() / 32768.)[:, None],
        'loudness': channels('loudness'),
        'pitch': data['pitch'][row, frames].float(),
        'periodicity': data['periodicity'][row, frames].float(),
        'ppg': channels('ppg'),
        'speakers': data['speakers'][rows].long(),
        'spectral_balance_ratios': data['spectral_balance_ratios'][rows],
        'loudness_ratios': data['loudness_ratios'][rows]}


def draw(data, generator, batch_size, chunk_frames):
    """(rows, starts) of `batch_size` crops, drawn on the corpus' device
    from `generator` (a `torch.Generator` there) by the JAX package's
    formula: a uniform stem, and start = floor(u * (length - chunk_frames
    + 1)) for a uniform u in [0, 1)"""
    device = data['lengths'].device
    count = data['lengths'].shape[0]
    rows = torch.randint(
        0, count, (batch_size,), generator=generator, device=device)
    max_start = (data['lengths'][rows] - chunk_frames).float()
    uniform = torch.rand(batch_size, generator=generator, device=device)
    starts = torch.floor(uniform * (max_start + 1.)).long()
    # u * (m + 1) can round up to m + 1 in float32
    return rows, torch.minimum(starts, max_start.long())


def sample(data, generator, batch_size=None, config=None):
    """One training batch of random crops, drawn and gathered on the card
    (`draw`, then `crops`); batch_size None takes config.BATCH_SIZE"""
    config = config_module.default() if config is None else config
    if batch_size is None:
        batch_size = config.BATCH_SIZE
    chunk_frames = config.CHUNK_SIZE // config.HOPSIZE
    rows, starts = draw(data, generator, batch_size, chunk_frames)
    return crops(data, rows, starts, chunk_frames)


def sample_sharded(data, generator, rank, world, batch_size=None,
                   config=None):
    """This rank's batch_size // world crops of the global batch, drawn
    from its own shard of the corpus (`to_device(..., rank, world)`) with
    its own generator: no collective is involved, and the rows come out
    as this rank's part of the data-parallel batch

    Raises ValueError when world does not divide the batch.
    """
    config = config_module.default() if config is None else config
    if batch_size is None:
        batch_size = config.BATCH_SIZE
    if batch_size % world != 0:
        raise ValueError(
            f'batch size {batch_size} must divide over data axis {world}')
    if not 0 <= rank < world:
        raise ValueError(f'rank {rank} is not in a world of {world}')
    return sample(data, generator, batch_size // world, config)
