"""Host utility tests mirroring the reference's own unit-test suite
(UnitTest/ThreadPoolTest.cpp scenarios) plus Event/TimeScope/align_up."""

import threading
import time

import pytest

from direct12pbrrenderer.utils.misc import Event, TimeScope, align_up
from direct12pbrrenderer.utils.threading import TaskQueue, ThreadPool


def test_thread_pool_schedule_futures():
    """ThreadPool.ScheduleTest: futures with results (ThreadPoolTest.cpp:27-38)."""
    pool = ThreadPool(4)
    try:
        f = pool.schedule(lambda a, b: a + b, 19, 23)
        assert f.result(timeout=5) == 42
    finally:
        pool.shutdown()


def test_thread_pool_by_reference_effects():
    """Mutating shared state from tasks (the by-ref args scenario)."""
    pool = ThreadPool(2)
    box = {"v": 0}
    lock = threading.Lock()

    def bump():
        with lock:
            box["v"] += 1

    try:
        futs = [pool.schedule(bump) for _ in range(50)]
        for f in futs:
            f.result(timeout=5)
        assert box["v"] == 50
    finally:
        pool.shutdown()


def test_thread_pool_hundred_concurrent_tasks():
    """100 concurrent tasks complete with correct results (:40-58)."""
    pool = ThreadPool(8)
    try:
        futs = [pool.schedule(lambda i=i: i * i) for i in range(100)]
        assert [f.result(timeout=10) for f in futs] == [i * i for i in range(100)]
    finally:
        pool.shutdown()


def test_thread_pool_exception_propagates():
    pool = ThreadPool(1)
    try:
        f = pool.schedule(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            f.result(timeout=5)
    finally:
        pool.shutdown()


def test_task_queue_manual_drain():
    q = TaskQueue()
    f1 = q.schedule(lambda: "a")
    f2 = q.schedule(lambda: "b")
    assert q.run_one(block=False) and q.run_one(block=False)
    assert not q.run_one(block=False)
    assert (f1.result(), f2.result()) == ("a", "b")


def test_event_multicast():
    ev = Event()
    got = []
    h1 = got.append
    ev += h1
    ev += lambda x: got.append(x * 10)
    ev(3)
    assert got == [3, 30]
    ev -= h1
    ev(4)
    assert got == [3, 30, 40]


def test_time_scope():
    records = []
    with TimeScope("work", log=lambda label, dt: records.append((label, dt))):
        time.sleep(0.01)
    assert records and records[0][0] == "work" and records[0][1] >= 0.009


def test_align_up():
    assert align_up(0, 256) == 0
    assert align_up(1, 256) == 256
    assert align_up(256, 256) == 256
    assert align_up(257, 256) == 512
