"""The port's pause protocol and job notifications (`utils.pause`,
`utils.notify`) against the JAX package's.

The pause tests are the port's copies of `tests/test_pause.py`, with the
protocol's directory given as a `config.Config` (RUNS_DIR under the
test's temporary directory), and a protocol test across the packages: a
JAX requester pauses a port trainer and a port requester a JAX trainer,
on one directory. Threads stand in for the trainer; every wait polls
with a generous deadline, so six test workers on one machine cannot
make it race. The notification tests never reach the network: the
webhook's `urlopen` is replaced. `data.augment.datasets` and
`data.preprocess.datasets` report as the JAX package's do. The last test
pins the CPU threads that the repository's root `conftest.py` gives every
test process and the processes it starts.
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

import promonet_tpu
from promonet_tpu.utils import pause as jax_pause

import promonet_tpu_torch as port
from promonet_tpu_torch.utils import notify, pause

DEADLINE = 60.


def _wait(predicate, timeout=DEADLINE):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


@pytest.fixture
def config(tmp_path):
    return port.config.load().replace(RUNS_DIR=tmp_path / 'runs')


###############################################################################
# Pause
###############################################################################


def test_pause_roundtrip(config):
    # No trainer registered: exclusive() is a no-op that reports False
    with pause.exclusive(config=config) as acked:
        assert acked is False

    pause.register_trainer(config)
    assert pause.trainer_alive(config)
    assert (config.RUNS_DIR / 'trainer.pid').read_text() == str(os.getpid())

    # maybe_pause without a request is a cheap no-op
    assert pause.maybe_pause(config=config) is False

    # The trainer thread parks on the request, drains, runs on_pause,
    # acknowledges, and resumes on release
    events, result = [], []
    thread = threading.Thread(target=lambda: result.append(pause.maybe_pause(
        drain=lambda: events.append('drain'),
        on_pause=lambda: events.append('checkpoint'),
        poll_seconds=0.02, config=config)))
    pause.pause_file(config).write_text(str(os.getpid()))
    thread.start()
    assert _wait(pause.ack_file(config).exists)
    assert events == ['drain', 'checkpoint']
    assert _wait(pause.heartbeat_file(config).exists)
    pause.pause_file(config).unlink()
    thread.join(DEADLINE)
    assert result == [True]
    assert not pause.ack_file(config).exists()
    assert not pause.pause_file(config).exists()

    pause.unregister_trainer(config)
    assert not pause.trainer_alive(config)


def test_exclusive_waits_for_ack(config):
    pause.register_trainer(config)
    try:
        # The context waits for the trainer's ack before yielding
        def trainer():
            assert _wait(pause.pause_file(config).exists)
            pause.maybe_pause(poll_seconds=0.02, config=config)

        thread = threading.Thread(target=trainer)
        thread.start()
        with pause.exclusive(poll_seconds=0.02, config=config) as acked:
            assert acked is True
            assert pause.ack_file(config).exists()
        thread.join(DEADLINE)
        assert not thread.is_alive()

        # A dead trainer pid does not block the requester
        pause.pid_file(config).write_text('999999999')
        start = time.time()
        with pause.exclusive(
                timeout=0.2, poll_seconds=0.02, config=config) as acked:
            assert acked is False
        assert time.time() - start < 10.
    finally:
        pause.unregister_trainer(config)


def test_stale_pause_is_expired(config):
    """A PAUSE left by a killed requester must not park the trainer"""
    pause.register_trainer(config)
    try:
        # Dead requester pid: expired on entry, the trainer does not pause
        pause.pause_file(config).write_text('999999999')
        assert pause.maybe_pause(poll_seconds=0.02, config=config) is False
        assert not pause.pause_file(config).exists()

        # A pid-less file: also stale
        pause.pause_file(config).touch()
        assert pause.maybe_pause(poll_seconds=0.02, config=config) is False
        assert not pause.pause_file(config).exists()
    finally:
        pause.unregister_trainer(config)


def test_requester_death_releases_paused_trainer(config):
    """A trainer already parked on a pause resumes when the owner dies"""
    pause.register_trainer(config)
    try:
        # The requester is a real process, alive at the request and dead
        # once its stdin closes
        requester = subprocess.Popen(['cat'], stdin=subprocess.PIPE)
        pause.pause_file(config).write_text(str(requester.pid))

        result = []
        thread = threading.Thread(target=lambda: result.append(
            pause.maybe_pause(poll_seconds=0.02, config=config)))
        thread.start()
        assert _wait(pause.ack_file(config).exists)
        requester.stdin.close()
        requester.wait()
        thread.join(DEADLINE)
        assert result == [True]
        assert not pause.pause_file(config).exists()
        assert not pause.ack_file(config).exists()
    finally:
        pause.unregister_trainer(config)


def _trainer_thread(maybe_pause, result):
    """A trainer's loop: one pause check per dispatch until one pauses"""
    def run():
        deadline = time.time() + DEADLINE
        while time.time() < deadline:
            if maybe_pause():
                result.append(True)
                return
            time.sleep(0.01)
        result.append(False)

    thread = threading.Thread(target=run)
    thread.start()
    return thread


@pytest.mark.parametrize('requester', ['jax', 'port'])
def test_pause_protocol_crosses_packages(config, requester):
    """One package's requester pauses the other package's trainer, on one
    directory: the protocol's files are the same"""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(promonet_tpu, 'RUNS_DIR', config.RUNS_DIR)
        if requester == 'jax':
            # A port trainer, a JAX requester
            trainer = dict(
                register=lambda: pause.register_trainer(config),
                unregister=lambda: pause.unregister_trainer(config),
                maybe_pause=lambda: pause.maybe_pause(
                    poll_seconds=0.02, config=config))
            exclusive = jax_pause.exclusive
        else:
            trainer = dict(
                register=jax_pause.register_trainer,
                unregister=jax_pause.unregister_trainer,
                maybe_pause=lambda: jax_pause.maybe_pause(poll_seconds=0.02))
            exclusive = lambda **kwargs: pause.exclusive(  # noqa: E731
                config=config, **kwargs)
        trainer['register']()
        try:
            result = []
            thread = _trainer_thread(trainer['maybe_pause'], result)
            with exclusive(poll_seconds=0.02) as acked:
                assert acked is True
                assert (config.RUNS_DIR / 'PAUSE.ack').exists()
                assert (config.RUNS_DIR / 'PAUSE').read_text() == str(
                    os.getpid())
                assert thread.is_alive()
            thread.join(DEADLINE)
            assert result == [True]
            assert not (config.RUNS_DIR / 'PAUSE').exists()
            assert not (config.RUNS_DIR / 'PAUSE.ack').exists()
        finally:
            trainer['unregister']()
        assert not (config.RUNS_DIR / 'trainer.pid').exists()


###############################################################################
# Notify
###############################################################################


def _records(config):
    file = config.RUNS_DIR / 'notifications.jsonl'
    return [json.loads(line) for line in file.read_text().splitlines()]


def test_notify_records_start_and_completion(config):
    @notify.notify('double')
    def job(value, config=None):
        return 2 * value

    assert job(3, config=config) == 6
    started, completed = _records(config)
    assert (started['job'], started['status']) == ('double', 'started')
    assert (completed['job'], completed['status']) == ('double', 'completed')
    assert completed['seconds'] >= 0 and completed['time'] >= started['time']
    assert job.__name__ == 'job' and job.__wrapped__(2) == 4


def test_notify_records_failure_and_reraises(config):
    @notify.notify('failing')
    def job(config=None):
        raise ValueError('no corpus')

    with pytest.raises(ValueError, match='no corpus'):
        job(config)
    started, failed = _records(config)
    assert started['status'] == 'started'
    assert failed['status'] == 'failed'
    assert failed['error'] == 'ValueError: no corpus'
    assert failed['seconds'] >= 0


def test_notify_takes_the_default_configuration(config, monkeypatch):
    monkeypatch.setattr(port.config, 'default', lambda: config)

    @notify.notify('default')
    def job():
        return 'done'

    assert job() == 'done'
    assert [r['status'] for r in _records(config)] == ['started', 'completed']


def test_notify_posts_to_the_webhook(config, monkeypatch):
    import urllib.request

    posts = []

    def urlopen(request, timeout):
        posts.append((request.full_url, request.get_method(),
                      request.headers, json.loads(request.data), timeout))

    monkeypatch.setattr(urllib.request, 'urlopen', urlopen)
    monkeypatch.setenv('PROMONET_NOTIFY_URL', 'http://localhost:9/hook')

    @notify.notify('hooked')
    def job(config=None):
        return 1

    job(config=config)
    assert [post[3]['status'] for post in posts] == ['started', 'completed']
    url, method, headers, record, timeout = posts[1]
    assert (url, method, timeout) == ('http://localhost:9/hook', 'POST', 5)
    assert headers['Content-type'] == 'application/json'
    assert record == _records(config)[1]

    # Without the variable nothing is posted
    posts.clear()
    monkeypatch.delenv('PROMONET_NOTIFY_URL')
    job(config=config)
    assert posts == []


def test_notify_swallows_log_and_webhook_errors(tmp_path, monkeypatch):
    import urllib.request

    def urlopen(request, timeout):
        raise OSError('unreachable')

    monkeypatch.setattr(urllib.request, 'urlopen', urlopen)
    monkeypatch.setenv('PROMONET_NOTIFY_URL', 'http://localhost:9/hook')
    # RUNS_DIR is a file: the log cannot be written
    blocked = tmp_path / 'blocked'
    blocked.write_text('')
    config = port.config.load().replace(RUNS_DIR=blocked)

    @notify.notify('quiet')
    def job(config=None):
        return 'ran'

    assert job(config=config) == 'ran'


@pytest.mark.parametrize('job', ['augment', 'preprocess'])
def test_dataset_steps_are_notified(config, job, monkeypatch):
    """`data.augment.datasets` and `data.preprocess.datasets` report their
    start and completion, or failure, to the log and the webhook, as the
    JAX package's do"""
    import urllib.request

    posts = []
    monkeypatch.setattr(
        urllib.request, 'urlopen',
        lambda request, timeout: posts.append(json.loads(request.data)))
    monkeypatch.setenv('PROMONET_NOTIFY_URL', 'http://localhost:9/hook')
    run = getattr(port.data, job).datasets
    config = config.replace(
        CACHE_DIR=config.RUNS_DIR.parent / 'cache',
        AUGMENT_DIR=config.RUNS_DIR.parent / 'augmentations')
    # An empty corpus: nothing to do
    (config.CACHE_DIR / 'empty').mkdir(parents=True)
    kwargs = {} if job == 'augment' else dict(
        features=('loudness',), device='cpu')
    run(['empty'], config=config, **kwargs)
    # A wav that does not decode
    (config.CACHE_DIR / 'broken' / '0000').mkdir(parents=True)
    (config.CACHE_DIR / 'broken' / '0000' / '000000-100.wav').write_bytes(
        b'RIFF')
    with pytest.raises(Exception):
        run(['broken'], config=config, **kwargs)
    records = _records(config)
    assert [(r['job'], r['status']) for r in records] == [
        (job, 'started'), (job, 'completed'), (job, 'started'),
        (job, 'failed')]
    assert posts == records
    assert getattr(promonet_tpu.data, job).datasets.__wrapped__


def test_train_and_evaluate_are_notified():
    assert port.train.__wrapped__.__name__ == 'train'
    assert port.evaluate.datasets.__wrapped__.__name__ == 'datasets'


###############################################################################
# Test processes
###############################################################################


def test_root_conftest_owns_the_threads_of_every_test_process(request):
    owner = request.config.pluginmanager.get_plugin(
        str(Path(__file__).resolve().parent.parent / 'conftest.py'))
    assert torch.get_num_threads() == owner.THREADS
    for name in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS'):
        assert os.environ[name] == str(owner.THREADS)
    result = subprocess.run(
        [sys.executable, '-c', 'import torch; print(torch.get_num_threads())'],
        capture_output=True, text=True, timeout=120, check=True)
    assert int(result.stdout) == owner.THREADS
