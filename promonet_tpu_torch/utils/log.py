"""Training metrics (counterpart of `promonet_tpu/utils/log.py`)

Every call appends the step's scalars to `<directory>/metrics.jsonl`, one
JSON object per line; where `torch.utils.tensorboard` imports (it needs
the `tensorboard` package), scalars, audio and figures also go to
TensorBoard event files in the same directory. Figures are closed in
either case.
"""
import json
import time
from pathlib import Path

_writers = {}


def _tensorboard_writer(directory):
    key = str(directory)
    if key not in _writers:
        try:
            from torch.utils.tensorboard import SummaryWriter
            _writers[key] = SummaryWriter(log_dir=key)
        except ImportError:
            _writers[key] = None
    return _writers[key]


def update(directory, step, scalars=None, audio=None, sample_rate=None,
           figures=None):
    """Log a step's scalars ({name: number}), audio ({name: samples}) and
    figures ({name: matplotlib Figure})"""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    writer = _tensorboard_writer(directory)
    if scalars:
        record = {'step': int(step), 'time': time.time()}
        for name, value in scalars.items():
            record[name] = float(value)
            if writer is not None:
                writer.add_scalar(name, float(value), int(step))
        with open(directory / 'metrics.jsonl', 'a') as file:
            file.write(json.dumps(record) + '\n')
    if writer is not None:
        for name, waveform in (audio or {}).items():
            writer.add_audio(
                name, waveform.reshape(-1, 1), int(step), sample_rate)
    for name, figure in (figures or {}).items():
        if writer is not None:
            writer.add_figure(name, figure, int(step), close=False)
        import matplotlib.pyplot as plt
        plt.close(figure)
    if writer is not None:
        writer.flush()
