"""Job start, completion and failure notifications (counterpart of
`promonet_tpu/utils/notify.py`)

`notify(name)` wraps a long-running job (`train`, `evaluate.datasets`,
`data.{download,augment,preprocess}.datasets`): each start, completion
and failure is appended as one JSON object to `RUNS_DIR /
'notifications.jsonl'`, and POSTed as JSON to the URL in
PROMONET_NOTIFY_URL where that is set (5 s timeout). Nothing leaves the
machine unless that variable is set. A failure of the log or of the
webhook is swallowed; the job's own exception is re-raised.

The JAX package reads its module-level RUNS_DIR; the port takes the
`config.Config` that the wrapped call receives as `config=` (else
`config.load()`'s default). In a `torch.distributed` process group
(data-parallel training) rank 0 alone reports, for the whole group.
"""
import functools
import inspect
import json
import os
import time
import traceback
from pathlib import Path

from .. import config as config_module

ENVIRONMENT_VARIABLE = 'PROMONET_NOTIFY_URL'


def notify(name):
    """Decorator: record the start, completion and failure of a job"""

    def decorator(fn):
        signature = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            bound = signature.bind_partial(*args, **kwargs).arguments
            config = bound.get('config')
            if config is None:
                config = config_module.default()
            emit = functools.partial(_emit, config.RUNS_DIR) if \
                _rank() == 0 else lambda *args, **kwargs: None
            emit(name, 'started')
            start = time.time()
            try:
                result = fn(*args, **kwargs)
            except Exception as error:
                emit(
                    name, 'failed', seconds=time.time() - start,
                    error=''.join(
                        traceback.format_exception_only(error)).strip())
                raise
            emit(name, 'completed', seconds=time.time() - start)
            return result

        return wrapped

    return decorator


def _rank():
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _emit(directory, name, status, **extra):
    record = {'job': name, 'status': status, 'time': time.time(), **extra}

    # Local log
    try:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        with open(directory / 'notifications.jsonl', 'a') as file:
            file.write(json.dumps(record) + '\n')
    except Exception:
        pass

    # Optional webhook
    url = os.environ.get(ENVIRONMENT_VARIABLE)
    if url:
        try:
            import urllib.request
            request = urllib.request.Request(
                url, data=json.dumps(record).encode(),
                headers={'Content-Type': 'application/json'})
            urllib.request.urlopen(request, timeout=5)
        except Exception:
            pass
