"""One timed call per card at a time: the card's ``flock``
(``repro_torch.measure.lock``) and the timing helpers that hold it
(``repro_torch.measure.timing``), on the CPU.

The lock helper runs over a file under ``tmp_path`` in real processes: a
second process blocks while the first holds the lock, a holder killed
with ``SIGKILL`` releases it (the kernel drops an ``flock`` with its
holder), and threads of one process exclude each other.  The timing
helpers take the lock named by the card's UUID around warmup and timed
repetitions, and never on the CPU.  The helper processes import only
``repro_torch.measure.lock`` (no torch), so they start at once.
"""
import fcntl
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.measure import WorkerPoolTransport, lock, timing
from repro_torch.models.site import KernelSite

SRC = str(Path(__file__).resolve().parents[1] / "src")
HOLD = ("import sys, time\n"
        "from repro_torch.measure import lock\n"
        "with lock.exclusive(sys.argv[1]):\n"
        "    print('held', flush=True)\n"
        "    time.sleep(float(sys.argv[2]))\n")
WAIT = ("import sys, time\n"
        "from repro_torch.measure import lock\n"
        "t0 = time.monotonic()\n"
        "with lock.exclusive(sys.argv[1]):\n"
        "    print(f'got {time.monotonic() - t0:.3f}', flush=True)\n")


def _spawn(code, *args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            stdout=subprocess.PIPE, text=True, env=env)


def _line(proc, timeout):
    """The process's next output line, or None after ``timeout`` s."""
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    return proc.stdout.readline().strip() if ready else None


def _held_elsewhere(path) -> bool:
    """True while some holder has ``path`` locked (a fresh open file
    description cannot take it)."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except BlockingIOError:
        return True
    finally:
        os.close(fd)
    return False


def test_a_second_process_blocks_while_the_first_holds_the_lock(tmp_path):
    path = str(tmp_path / "card.lock")
    holder = _spawn(HOLD, path, 3.0)
    waiter = None
    try:
        assert _line(holder, 60) == "held"
        waiter = _spawn(WAIT, path)
        assert _line(waiter, 0.8) is None       # blocked behind the holder
        assert waiter.poll() is None and holder.poll() is None
        got = _line(waiter, 60)                 # the holder let go
        assert got is not None and got.startswith("got")
        assert holder.poll() is not None or holder.wait(timeout=5) == 0
        assert holder.returncode == 0 and waiter.wait(timeout=60) == 0
    finally:
        for p in (holder, waiter):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def test_a_killed_holder_releases_the_lock(tmp_path):
    path = str(tmp_path / "card.lock")
    holder = _spawn(HOLD, path, 3600)
    waiter = None
    try:
        assert _line(holder, 60) == "held"
        assert _held_elsewhere(path)
        waiter = _spawn(WAIT, path)
        assert _line(waiter, 0.8) is None
        holder.send_signal(signal.SIGKILL)
        assert holder.wait(timeout=30) == -signal.SIGKILL
        got = _line(waiter, 60)
        assert got is not None and got.startswith("got")
        assert waiter.wait(timeout=60) == 0
        # the file stays; its existence is not the lock
        assert os.path.exists(path) and not _held_elsewhere(path)
    finally:
        for p in (holder, waiter):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def test_threads_of_one_process_exclude_each_other(tmp_path):
    path = str(tmp_path / "card.lock")
    before = lock.stats.acquires
    inside, overlaps = [0], [0]
    guard = threading.Lock()

    def body():
        for _ in range(40):
            with lock.exclusive(path):
                with guard:
                    inside[0] += 1
                    overlaps[0] += inside[0] > 1
                time.sleep(0.0005)
                with guard:
                    inside[0] -= 1

    threads = [threading.Thread(target=body) for _ in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert overlaps[0] == 0
    assert lock.stats.acquires == before + 160
    spans = sorted(list(lock.stats.spans)[-160:])
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert lock.stats.held_s > 0 and lock.stats.wait_s >= 0


def test_lock_file_is_named_by_the_card_in_the_temp_dir(monkeypatch,
                                                        tmp_path):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    p = lock.lock_path("GPU-1b2c/../x y")
    assert os.path.dirname(p) == str(tmp_path)
    assert os.path.basename(p) == "repro_torch-card-GPU-1b2c____x_y.lock"
    assert lock.lock_path("a") != lock.lock_path("b")


def test_timing_takes_no_lock_on_the_cpu():
    before = lock.stats.acquires
    timing.median_time(lambda: torch.ones(3), reps=2, warmup=1)
    timing.median_time(lambda: torch.ones(3), reps=2, warmup=1,
                       device="cpu")
    timing.interleaved_medians(lambda: 1, lambda: 2, reps=2, device="cpu")
    assert lock.stats.acquires == before


def test_timing_holds_the_card_lock_around_warmup_and_reps(monkeypatch,
                                                           tmp_path):
    """On a card (faked here: its UUID, and a synchronise that does
    nothing) every call of one ``median_time``, warmup included, runs
    while the file named by the card's UUID is locked: one acquisition a
    call.  ``interleaved_medians`` likewise."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    class Props:
        uuid = "GPU-test-card"

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda idx: Props())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(timing, "_UUIDS", {})
    path = lock.lock_path("GPU-test-card")
    seen = []

    def fn():
        seen.append(_held_elsewhere(path))
        return 1

    before = lock.stats.acquires
    timing.median_time(fn, reps=3, warmup=2, device="cuda")
    assert seen == [True] * 5
    assert lock.stats.acquires == before + 1
    timing.interleaved_medians(fn, fn, reps=2, device="cuda:0")
    assert seen == [True] * 9 and lock.stats.acquires == before + 2
    assert not _held_elsewhere(path)


def test_a_worker_reports_its_lock_use(tmp_path, monkeypatch):
    """A pool worker writes what its timings did with the lock into its
    launch file (none on the CPU: the lock is for cards)."""
    monkeypatch.setenv("REPRO_TORCH_LAUNCH_DIR", str(tmp_path))
    site = KernelSite(site="t.mm", kind="matmul", m=32, n=128, k=128)
    with WorkerPoolTransport(workers=1, factory="test_torch_pool_helpers:"
                             "deterministic", spawn_timeout=60.0,
                             job_timeout=60.0) as t:
        v = t.submit([site], np.array([[16, 128, 128]]))[0].result()
    assert np.isfinite(v)
    files = list(tmp_path.glob("worker-*.json"))
    assert len(files) == 1
    rec = json.loads(files[0].read_text())
    assert rec["timing_lock"] == {"acquires": 0, "wait_s": 0.0,
                                  "held_s": 0.0}
    assert rec["timing_lock_spans"] == []
