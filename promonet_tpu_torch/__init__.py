"""promonet_tpu_torch — the PyTorch/CUDA port of promonet_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs. It has the
editing chain: `preprocess.from_audio` (loudness, pitch from the CNN or
the NCC front end with Viterbi or argmax decoding, periodicity, PPG,
harmonic contours) → `edit.from_features` (pitch shift, constant-ratio or
PPG-aware time stretch, loudness scale) → `synthesize.from_features`
(HiFi-GAN, FARGAN or Vocos), and `synthesize.from_edited_audio` for the
whole chain in one call; batched synthesis
(`synthesize.from_features_batched`), streaming (`synthesize.Streamer`,
`synthesize.FARGANStreamer`), zero-shot speakers (`preprocess.speaker`,
`ZERO_SHOT` generators), the `from_file*` entry points that read and
write the JAX package's files, the spectrogram-only baseline
(`models.MelGenerator`, `baseline.mels`), objective evaluation
(`evaluate.datasets` over the formant-synthesis corpus of
`data.synthetic`, the partitions of `partition` and `data.Dataset`), and
the command line (`python -m
promonet_tpu_torch.{preprocess,edit,synthesize,evaluate}`), and GAN
training and speaker adaptation (`train`, `models.Discriminator`,
`loss`, the chunked `data.Dataset` path, `data.loader`, `data.augment`,
`adapt.speaker`, `evaluate.datasets(adapt=True)`, `python -m
promonet_tpu_torch.{train,adapt}`; FARGAN's training route), the WORLD
baseline (`baseline.world`) and its evaluation, packed features and the
exported packed-inference program (`models.export`, `data.pack`),
CARGAN (`models.cargan`), dataset formatting (`data.download`), the
dataset command lines (`python -m promonet_tpu_torch.{data.download,
partition,data.preprocess,data.pack,models.export}`),
device-resident training data with several steps a dispatch
(`data.resident`), data-parallel training over `torch.distributed`
(`parallel`, `torchrun -m promonet_tpu_torch.train`), the trainer's
pause protocol and job notifications (`utils.pause`, `utils.notify`),
and figures (`plot`, `python -m promonet_tpu_torch.plot`).
Each Pallas kernel of
the JAX package is a hand-written CUDA kernel here (`csrc/`), beside a
plain PyTorch version that serves CPU tensors. Entry points run on the
GPU unless called with device='cpu'.

The port imports neither JAX nor the JAX package. Configuration is an
explicit `config.Config` (see `config.load`); weights come from the
port's checkpoint files (`utils.checkpoint`, read by `load`), trained by
the port (`train`, and `preprocess.{pitch,ppg,speaker}.train` for the
feature extractors); from the JAX package's orbax checkpoints, which
`utils.checkpoint` reads without JAX and `models.bridge` carries over
(the shipped extractors by default, the release generator by path); or
from a seed through `models.init.seeded`.
"""
from . import config
from . import convert
from . import data
from . import device
from . import edit
from . import load
from . import models
from . import ops
from . import parallel
from . import partition
from . import preprocess
from . import synthesize
from . import baseline
from . import evaluate
from .train import loss, train
from . import adapt
from . import plot
from . import utils

# The JAX package's alias of `models` (the reference's `promonet.model`)
model = models
