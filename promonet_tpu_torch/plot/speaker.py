"""Speaker-embedding cluster plots (counterpart of
`promonet_tpu/plot/speaker.py`): a 2-D projection by the package's own
UMAP (`plot.umap`, on the host) of speaker embeddings, such as the
speaker encoder's x-vectors (`preprocess.speaker.from_audio`), and of
the embeddings of their reconstructions where given."""
import numpy as np

from .core import _host
from .umap import UMAP


def from_embeddings(embeddings, labels=None, predicted_embeddings=None):
    """2-D UMAP scatter of speaker embeddings, a matplotlib Figure

    embeddings: (N, D) tensor or array; labels: N colour values (speaker
    ids); predicted_embeddings: (M, D), drawn as crosses, projected
    together with the others
    """
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    embeddings = _host(embeddings)
    stacked = embeddings
    if predicted_embeddings is not None:
        stacked = np.concatenate([embeddings, _host(predicted_embeddings)])
    labels = None if labels is None else _host(labels)

    projected = UMAP().fit_transform(stacked)

    figure, axis = plt.subplots(figsize=(6, 6))
    n = len(embeddings)
    axis.scatter(
        projected[:n, 0], projected[:n, 1], c=labels,
        marker='o', label='ground truth', alpha=.7)
    if predicted_embeddings is not None:
        axis.scatter(
            projected[n:, 0], projected[n:, 1], c=labels,
            marker='x', label='reconstructed', alpha=.7)
    axis.legend()
    axis.set_title('Speaker embeddings')
    return figure
