"""Cooperative trainer pause for exclusive use of the card (counterpart of
`promonet_tpu/utils/pause.py`)

A long training run keeps the card busy, so a measurement started beside
it (an evaluation's timed phases, a benchmark) would measure contention.
Rather than kill the trainer, the measurement asks it to pause: the
trainer looks for a PAUSE file once per dispatch, drains its queued work
(`synchronize`), checkpoints, acknowledges, and idles until released.

Protocol files, under config.RUNS_DIR, the same files with the same
contents as the JAX package's, so a requester of either package pauses a
trainer of either:
    trainer.pid  written by the trainer at its start, removed at its end
    PAUSE        created by a requester; holds the requester's pid, so
                 that a trainer expires a request whose owner died
                 without removing it (a killed benchmark never runs its
                 `finally`)
    PAUSE.ack    created by the trainer once drained and idle
    heartbeat    touched by the trainer once per dispatch and while it
                 idles, for a watchdog to read
Every function takes the `config.Config` whose RUNS_DIR holds them
(None: `config.load()`'s default).
"""
import contextlib
import os
import sys
import time

import torch

from .. import config as config_module


def _runs_dir(config):
    config = config_module.default() if config is None else config
    config.RUNS_DIR.mkdir(parents=True, exist_ok=True)
    return config.RUNS_DIR


def pause_file(config=None):
    return _runs_dir(config) / 'PAUSE'


def ack_file(config=None):
    return _runs_dir(config) / 'PAUSE.ack'


def pid_file(config=None):
    return _runs_dir(config) / 'trainer.pid'


def heartbeat_file(config=None):
    return _runs_dir(config) / 'heartbeat'


def heartbeat(config=None):
    """Touch the liveness file: once per dispatch, and while paused"""
    heartbeat_file(config).touch()


def synchronize(device):
    """A trainer's drain on `device`: returns once the card has run all the
    work queued on it, so that it is idle during the pause"""
    device = torch.device(device)

    def drain():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    return drain


###############################################################################
# Trainer side
###############################################################################


def register_trainer(config=None):
    """Record this process as the active trainer"""
    pid_file(config).write_text(str(os.getpid()))


def unregister_trainer(config=None):
    for path in (pid_file(config), ack_file(config)):
        try:
            path.unlink()
        except FileNotFoundError:
            pass


def _alive(file):
    """Whether the process whose pid `file` holds is running; a missing
    file, or one without a pid, is not"""
    try:
        pid = int(file.read_text())
    except (FileNotFoundError, ValueError):
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _expire_stale_pause(config):
    try:
        pause_file(config).unlink()
    except FileNotFoundError:
        pass


def maybe_pause(drain=None, poll_seconds=1., on_pause=None, config=None):
    """If a pause is requested, drain, run `on_pause`, acknowledge and idle
    until released; returns whether it paused

    Called once per dispatch by the trainer, with `synchronize(device)` as
    `drain` and a checkpoint as `on_pause`, which runs after the drain and
    before the acknowledgement. A request whose owner has died is expired
    instead of honoured, on entry and while idling.
    """
    if not pause_file(config).exists():
        return False
    if not _alive(pause_file(config)):
        _expire_stale_pause(config)
        return False
    if drain is not None:
        drain()
    if on_pause is not None:
        on_pause()
    ack_file(config).touch()
    try:
        while pause_file(config).exists():
            if not _alive(pause_file(config)):
                _expire_stale_pause(config)
                break
            heartbeat(config)
            time.sleep(poll_seconds)
    finally:
        try:
            ack_file(config).unlink()
        except FileNotFoundError:
            pass
    return True


###############################################################################
# Requester side
###############################################################################


def trainer_alive(config=None):
    return _alive(pid_file(config))


@contextlib.contextmanager
def exclusive(timeout=600., poll_seconds=.5, config=None):
    """Hold the card alone for the duration of the block

    If a live trainer is registered, ask it to pause and wait up to
    `timeout` seconds for its acknowledgement (it may be inside a dispatch
    or a validation pass) before yielding. Yields True only once the
    trainer has drained and acknowledged; False means that measurements
    may be contended. Always releases on exit.
    """
    if not trainer_alive(config):
        yield False
        return
    pause_file(config).write_text(str(os.getpid()))
    try:
        deadline = time.time() + timeout
        while (time.time() < deadline
               and not ack_file(config).exists()
               and trainer_alive(config)):
            time.sleep(poll_seconds)
        acked = ack_file(config).exists()
        if not acked and trainer_alive(config):
            print(
                'pause.exclusive: trainer did not acknowledge within '
                f'{timeout:.0f}s; measurements may be contended',
                file=sys.stderr)
        yield acked
    finally:
        try:
            pause_file(config).unlink()
        except FileNotFoundError:
            pass
