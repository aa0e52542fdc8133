"""``ops/_build.lib()`` builds and loads the kernel library once when
several threads ask for it at the same moment (a server's sessions making
their first launch together).  ``build`` names its object files and its
temporary library by pid alone, so two builds in one process would write
the same files; here ``build`` and ``ctypes.CDLL`` are stand-ins that count
their calls."""

import sys
import threading
import time

import pytest

from dips_tpu_torch.ops import _build


class _Handle:
    """What ``ctypes.CDLL`` returns, with every entry point ``lib()``
    declares."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, type("Fn", (), {})())


@pytest.mark.parametrize("threads", [2, 8])
def test_lib_builds_and_loads_once_under_concurrent_first_use(
        monkeypatch, threads):
    calls = {"build": 0, "load": 0}
    count_lock = threading.Lock()

    def slow_build(force=False):
        with count_lock:
            calls["build"] += 1
        time.sleep(0.2)  # an nvcc pass: the others arrive meanwhile
        return "libdips_kernels.so"

    def load(path):
        with count_lock:
            calls["load"] += 1
        return _Handle()

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", load)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(threads)
        got = [None] * threads

        def first_use(i):
            start.wait(timeout=10)
            got[i] = _build.lib()

        ts = [threading.Thread(target=first_use, args=(i,))
              for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert calls == {"build": 1, "load": 1}
    assert got[0] is not None and all(g is got[0] for g in got)
    assert _build.lib() is got[0]  # later calls load nothing
    assert calls == {"build": 1, "load": 1}
    for name in _build.SIGNATURES:
        assert got[0].fns[name].restype is _build.ctypes.c_int
