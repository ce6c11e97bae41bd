"""The port's figures (`plot`) against the JAX package's.

- UMAP: the port's copy gives exactly the JAX package's layout (`==`) on
  seeded clusters, at a second seed, and on the tiny-input fallback;
  fewer epochs than the default keep the pure-Python layout quick, and
  both sides get the same.
- `plot.from_features`: from the same seeded features and targets, the
  same panels, the same y-data of every line and the same number of red
  error spans as the JAX package's figure.
- `plot.speaker.from_embeddings` and `python -m promonet_tpu_torch.plot`
  (in-process) draw and save with the Agg backend.
"""
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

import promonet_tpu  # noqa: E402
from promonet_tpu.plot import core as jax_plot  # noqa: E402
from promonet_tpu.plot.umap import UMAP as JaxUMAP  # noqa: E402

import promonet_tpu_torch as port  # noqa: E402
from promonet_tpu_torch.plot.umap import UMAP  # noqa: E402


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close('all')


def _clusters(seed, clusters=3, points=8, dims=16):
    rng = np.random.default_rng(seed)
    centers = 4. * rng.standard_normal((clusters, dims))
    return np.concatenate([
        center + rng.standard_normal((points, dims)) for center in centers
    ]).astype(np.float32)


@pytest.mark.parametrize('data_seed, random_state, epochs', [
    (0, 0, 40), (5, 7, 60)])
def test_umap_equals_jax(data_seed, random_state, epochs):
    data = _clusters(data_seed)
    ours = UMAP(n_epochs=epochs, random_state=random_state).fit_transform(data)
    theirs = JaxUMAP(
        n_epochs=epochs, random_state=random_state).fit_transform(data)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == (len(data), 2)
    np.testing.assert_array_equal(ours, theirs)
    # The clusters stay apart: each point's nearest neighbour in the
    # layout is of its own cluster
    labels = np.repeat(np.arange(3), 8)
    distances = np.linalg.norm(ours[:, None] - ours[None], axis=-1)
    np.fill_diagonal(distances, np.inf)
    assert (labels[distances.argmin(1)] == labels).mean() >= .9


def test_umap_tiny_input_fallback_equals_jax():
    data = _clusters(3)[:3]
    ours = UMAP().fit_transform(data)
    np.testing.assert_array_equal(ours, JaxUMAP().fit_transform(data))
    assert ours.shape == (3, 2)


def _features(seed, frames=40):
    rng = np.random.default_rng(seed)
    ppg = rng.random((40, frames)).astype(np.float32)
    return dict(
        audio=(0.3 * rng.standard_normal((1, frames * 256))).astype(
            np.float32),
        loudness=rng.uniform(-60, 0, (1, 513, frames)).astype(np.float32),
        pitch=rng.uniform(80, 300, (1, frames)).astype(np.float32),
        periodicity=rng.random((1, frames)).astype(np.float32),
        ppg=ppg / ppg.sum(0))


def _summary(figure):
    """Per axis: its label, each line's y-data, red spans, images"""
    return [
        (axis.get_ylabel(),
         [np.asarray(line.get_ydata()) for line in axis.get_lines()],
         sum(patch.get_facecolor()[:3] == (1., 0., 0.)
             for patch in axis.patches),
         [np.asarray(image.get_array()) for image in axis.get_images()])
        for axis in figure.axes]


@pytest.mark.parametrize('features', [
    None, ['pitch', 'loudness'], ['ppg']])
def test_from_features_matches_jax(features):
    predicted, target = _features(1), _features(2)
    # Some frames within the thresholds, so not every frame is red
    target['pitch'][..., :10] = predicted['pitch'][..., :10] * 1.01
    target['periodicity'][..., :10] = predicted['periodicity'][..., :10]
    target['loudness'] = predicted['loudness'] + np.where(
        np.arange(40) < 10, 1., 10.).astype(np.float32)
    targets = dict(
        target_loudness=target['loudness'][0],
        target_pitch=target['pitch'][0],
        target_periodicity=target['periodicity'][0])
    theirs = _summary(jax_plot.from_features(
        **predicted, **targets, features=features))
    # The port takes tensors as well as arrays
    ours = _summary(port.plot.from_features(
        **{name: torch.from_numpy(value) for name, value in predicted.items()},
        **targets, features=features))
    assert len(ours) == len(theirs) == len(
        features or promonet_tpu.DEFAULT_PLOT_FEATURES)
    for (label, lines, spans, images), (label_, lines_, spans_, images_) in \
            zip(ours, theirs):
        assert label == label_
        assert len(lines) == len(lines_) and len(images) == len(images_)
        for ydata, ydata_ in zip(lines + images, lines_ + images_):
            np.testing.assert_array_equal(ydata, ydata_)
        assert spans == spans_
        if label in ('pitch', 'periodicity', 'loudness'):
            assert 0 < spans < 40


def test_from_features_leaves_out_missing_panels():
    features = _features(3)
    figure = port.plot.from_features(
        pitch=features['pitch'], ppg=torch.from_numpy(features['ppg']).to(
            torch.bfloat16))
    assert [axis.get_ylabel() for axis in figure.axes] == ['pitch', 'ppg']


def test_speaker_figure_projects_every_embedding():
    embeddings = torch.from_numpy(_clusters(4))
    labels = np.repeat(np.arange(3), 8)
    figure = port.plot.speaker.from_embeddings(
        embeddings, labels, predicted_embeddings=embeddings + 0.01)
    axis, = figure.axes
    assert [len(collection.get_offsets()) for collection in
            axis.collections] == [24, 24]
    assert axis.get_title() == 'Speaker embeddings'


def test_command_line_saves_the_figure(tmp_path, monkeypatch):
    config = port.config.load()
    features = _features(5)
    prefix = tmp_path / 'item-100'
    pitch_prefix = f'{prefix}-viterbi' if config.VITERBI_DECODE_PITCH else \
        str(prefix)
    np.save(f'{prefix}-loudness.npy', features['loudness'][0])
    np.save(f'{pitch_prefix}-pitch.npy', features['pitch'])
    np.save(f'{pitch_prefix}-periodicity.npy', features['periodicity'])
    np.save(f'{prefix}-ppg.npy', features['ppg'])
    port.utils.audio.save(
        tmp_path / 'item-100.wav', features['audio'], config.SAMPLE_RATE)
    output = tmp_path / 'figure.png'
    monkeypatch.setattr(sys, 'argv', [
        'plot', '--output_file', str(output),
        '--audio_file', str(tmp_path / 'item-100.wav'),
        '--prefix', str(prefix), '--target_prefix', str(prefix),
        '--features', 'audio', 'pitch', 'ppg'])
    from promonet_tpu_torch.plot import __main__ as command
    command.main()
    assert output.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
