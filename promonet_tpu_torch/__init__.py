"""promonet_tpu_torch — the PyTorch/CUDA port of promonet_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs. It has the
editing chain: `preprocess.from_audio` (loudness, CNN pitch with Viterbi
decoding, periodicity, PPG) → `edit.from_features` (pitch shift,
constant-ratio time stretch, loudness scale) → `synthesize.from_features`
(HiFi-GAN). Each Pallas kernel of the JAX package on that chain is a
hand-written CUDA kernel here (`csrc/`), beside a plain PyTorch version
that serves CPU tensors. Entry points run on the GPU unless called with
device='cpu'.

The port imports neither JAX nor the JAX package. Configuration is an
explicit `config.Config` (see `config.load`); weights come from the JAX
package's checkpoints through `models.bridge`, or from a seed through
`models.init.seeded`.
"""
from . import config
from . import convert
from . import data
from . import device
from . import edit
from . import load
from . import models
from . import ops
from . import preprocess
from . import synthesize
