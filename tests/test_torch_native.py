"""The port's framepump binding (``dips_tpu_torch.native``) against the JAX
package's (``dips_tpu.native``).

``planarize`` / ``interleave`` at every SIMD tier the host has and in the
numpy fallback, and ``FrameRing`` native and in its Python fallback, each
held against ``dips_tpu.native`` (and ``ops/reference.planarize_host``,
the engines' plain twin) on the same inputs made with numpy from a seed:
byte-equal.  Then the build: a stale library is rebuilt, and six fresh
processes importing a copy of the module at once all get the library
(the build runs under a directory lock).
"""

import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest

import dips_tpu.native as jnative
import dips_tpu_torch.native as tnative
from dips_tpu_torch.ops.reference import planarize_host

ROOT = Path(__file__).resolve().parents[1]
TIERS = ["scalar", "ssse3", "avx512"]
HAVE_TOOLCHAIN = bool(shutil.which("g++") and shutil.which("make"))


@pytest.fixture(params=["native", "fallback"])
def impl(request, monkeypatch):
    """Run the test on the loaded library and on the numpy fallback (the
    port's module with its library handle taken away)."""
    if request.param == "native":
        if not tnative.NATIVE_AVAILABLE:
            pytest.skip("native framepump unavailable")
    else:
        monkeypatch.setattr(tnative, "_lib", None)
    return request.param


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("cin", [3, 4])
def test_planarize_matches_jax(swap, cin, impl):
    rng = np.random.default_rng(cin + 2 * swap)
    frame = rng.integers(0, 256, (48, 64, cin), np.uint8)
    got = tnative.planarize(frame, 48, 128, swap_rb=swap)
    np.testing.assert_array_equal(
        got, jnative.planarize(frame, 48, 128, swap_rb=swap))
    np.testing.assert_array_equal(
        got, planarize_host(frame[..., :3], 48, 128, swap_rb=swap))
    # into a caller's buffer (padding rewritten, stale bytes cleared)
    out = np.full((3, 48, 128), 77, np.uint8)
    assert tnative.planarize(frame, 48, 128, swap_rb=swap, out=out) is out
    np.testing.assert_array_equal(out, got)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("c", [1, 3])
def test_interleave_matches_jax(swap, c, impl):
    rng = np.random.default_rng(10 + c + swap)
    planes = rng.integers(0, 256, (c, 48, 128), np.uint8)
    got = tnative.interleave(planes, 45, 61, swap_rb=swap)
    np.testing.assert_array_equal(
        got, jnative.interleave(planes, 45, 61, swap_rb=swap))
    exp = np.moveaxis(np.broadcast_to(planes[:, :45, :61], (3, 45, 61)),
                      0, -1)
    np.testing.assert_array_equal(got, exp[..., ::-1] if swap else exp)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("w", [1, 15, 16, 17, 63, 64, 65, 127, 128, 129])
def test_simd_tiers_match_jax(w, tier, monkeypatch):
    """Widths straddling the 16- and 64-pixel SIMD blocks, on every tier
    the host runs (``DIPS_TPU_SIMD`` caps both packages' dispatch): the
    port equals the JAX binding and the plain twin, both ways."""
    if not tnative.NATIVE_AVAILABLE:
        pytest.skip("native framepump unavailable")
    monkeypatch.setenv("DIPS_TPU_SIMD", tier)
    if tier != "scalar" and tnative.simd_level() == 0:
        pytest.skip(f"host cannot run the {tier} tier")
    assert tnative.simd_level() == jnative.simd_level()
    rng = np.random.default_rng(w)
    h, hp, wp = 5, 8, 192
    for cin in (3, 4):
        frame = rng.integers(0, 256, (h, w, cin), np.uint8)
        for swap in (False, True):
            got = tnative.planarize(frame, hp, wp, swap_rb=swap)
            np.testing.assert_array_equal(
                got, jnative.planarize(frame, hp, wp, swap_rb=swap))
            np.testing.assert_array_equal(
                got, planarize_host(frame[..., :3], hp, wp, swap_rb=swap))
    planes = rng.integers(0, 256, (3, hp, wp), np.uint8)
    for swap in (False, True):
        np.testing.assert_array_equal(
            tnative.interleave(planes, h, w, swap_rb=swap),
            jnative.interleave(planes, h, w, swap_rb=swap))


def test_simd_level_and_names_match_jax(monkeypatch):
    assert tnative.SIMD_NAMES == jnative.SIMD_NAMES
    assert tnative.NATIVE_AVAILABLE == jnative.NATIVE_AVAILABLE
    assert tnative.simd_level() == jnative.simd_level()
    if not tnative.NATIVE_AVAILABLE:
        assert tnative.simd_level() == -1
        return
    for env, lvl in (("scalar", 0), ("avx2", 0), ("AVX512", 0)):
        # an unknown name pins the safest tier, as in the JAX binding
        monkeypatch.setenv("DIPS_TPU_SIMD", env)
        assert tnative.simd_level() == jnative.simd_level() == lvl
    monkeypatch.setattr(tnative, "_lib", None)
    assert tnative.simd_level() == -1


def test_planarize_roundtrip_at_1080p_width(impl):
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (16, 1920, 3), np.uint8)
    planes = tnative.planarize(frame, 16, 2048, swap_rb=True)
    np.testing.assert_array_equal(
        tnative.interleave(planes, 16, 1920, swap_rb=True), frame)


def test_layout_rejects_oversized_frames():
    """Mid-stream geometry growth fails loudly in both packages."""
    for mod in (tnative, jnative):
        with pytest.raises(ValueError, match="exceeds padded"):
            mod.planarize(np.zeros((16, 200, 3), np.uint8), 16, 128)
        with pytest.raises(ValueError, match="exceeds plane"):
            mod.interleave(np.zeros((3, 8, 128), np.uint8), 16, 64)
        ring = mod.FrameRing(slots=2, slot_bytes=64)
        with pytest.raises(ValueError, match="slot size"):
            ring.push(np.zeros(65, np.uint8))
        with pytest.raises(TypeError, match="uint8"):
            ring.push(np.zeros(64, np.int16)[:32])
        ring.close()


@pytest.fixture(params=["native", "fallback"])
def rings(request):
    """A maker of (port ring, JAX ring) pairs on the same implementation."""
    use_native = request.param == "native"
    if use_native and not tnative.NATIVE_AVAILABLE:
        pytest.skip("native framepump unavailable")

    def mk(slots, slot_bytes):
        return (tnative.FrameRing(slots, slot_bytes, use_native=use_native),
                jnative.FrameRing(slots, slot_bytes, use_native=use_native))
    return mk


def _drain(ring, slot_bytes, produced):
    """Push ``produced`` from a thread, pop everything: (frames, codes)."""
    def producer():
        for p in produced:
            assert ring.push(p)
        ring.close()

    t = threading.Thread(target=producer)
    t.start()
    got, codes = [], []
    buf = np.empty(slot_bytes, np.uint8)
    while True:
        rc = ring.pop(buf, timeout_ms=10000)
        codes.append(rc)
        if rc == -1:
            break
        got.append(buf.copy())
    t.join()
    return got, codes


def test_ring_order_and_backpressure_match_jax(rings):
    produced = [np.full(16, i, np.uint8) for i in range(40)]
    results = [_drain(r, 16, produced) for r in rings(4, 16)]
    (tg, tc), (jg, jc) = results
    assert tc == jc == [0] * 40 + [-1]
    for a, b, p in zip(tg, jg, produced):
        np.testing.assert_array_equal(a, p)
        np.testing.assert_array_equal(b, p)


def test_ring_timeout_close_and_len_match_jax(rings):
    for ring in rings(3, 8):
        buf = np.empty(8, np.uint8)
        assert ring.pop(buf, timeout_ms=30) == -2  # empty, not closed
        assert ring.push(np.arange(8, dtype=np.uint8))
        assert ring.push(np.arange(8, dtype=np.uint8) + 1)
        assert len(ring) == 2
        assert ring.pop(buf) == 0 and buf[0] == 0 and len(ring) == 1
        ring.close()
        assert not ring.push(np.zeros(8, np.uint8))  # closed: rejected
        assert ring.pop(buf) == 0 and buf[0] == 1  # drains after close
        assert ring.pop(buf, timeout_ms=30) == -1  # closed and drained
        with pytest.raises(ValueError, match="C-contiguous"):
            ring.pop(np.empty((8, 2), np.uint8)[:, 0])


def test_ring_concurrent_stress(rings):
    """Strict FIFO without tearing under a racing producer, in both
    packages."""
    produced = [np.full(256, i % 251, np.uint8) for i in range(500)]
    for ring in rings(3, 256):
        got, codes = _drain(ring, 256, produced)
        assert len(got) == 500 and codes[-1] == -1
        assert all((g == i % 251).all() for i, g in enumerate(got))


@pytest.fixture
def native_ring():
    if not tnative.NATIVE_AVAILABLE:
        pytest.skip("native framepump unavailable")


def _frames(n, size, seed):
    """``n`` frames of ``size`` seeded random bytes, each stamped with its
    index in its first two bytes."""
    frames = np.random.default_rng(seed).integers(0, 256, (n, size),
                                                   dtype=np.uint8)
    frames[:, 0], frames[:, 1] = np.arange(n) % 256, np.arange(n) // 256
    return frames


@pytest.mark.parametrize("slot_bytes,pooled", [(4096, True), (512, False)])
def test_ring_pooled_pop_stress(native_ring, monkeypatch, slot_bytes,
                                pooled):
    """With the pool threshold patched down to 1 KiB (and 256-byte
    chunks on four copiers), slots above it pop through the pool and
    slots at or below it on the calling thread, under a racing producer:
    every frame in order, every byte exact; ``pooled_pops`` counts the
    large slots' pops only."""
    from dips_tpu_torch.utils import staging
    monkeypatch.setattr(staging, "POOL_ABOVE", 1024)
    monkeypatch.setattr(staging, "CHUNK_BYTES", 256)
    monkeypatch.setattr(staging, "pool_threads", lambda: 4)
    frames = _frames(400, slot_bytes, seed=slot_bytes)
    ring = tnative.FrameRing(3, slot_bytes)
    got, codes = _drain(ring, slot_bytes, list(frames))
    assert codes == [0] * len(frames) + [-1]
    np.testing.assert_array_equal(np.stack(got), frames)
    assert ring.pops == len(frames)
    assert ring.pooled_pops == (len(frames) if pooled else 0)


def _push_in_flight(ring, frame):
    """Start a thread that pushes ``frame``; returns (thread, its
    (start, end, result) once done), after the push has had 2 ms to
    start its copy."""
    started, box = threading.Event(), {}

    def producer():
        started.set()
        t0 = time.perf_counter()
        ok = ring.push(frame)
        box["push"] = (t0, time.perf_counter(), ok)

    th = threading.Thread(target=producer)
    th.start()
    assert started.wait(10)
    time.sleep(0.002)
    return th, box


BIG = 64 << 20  # a push of this many bytes into a fresh slot takes tens
#                 of ms; a 4 KiB pop takes microseconds


def test_ring_pops_while_a_push_copies(native_ring):
    """A pop of a published frame completes while the producer's copy of
    the next one is still in flight: the copies run outside the ring's
    lock.  (A ring that copies under its lock holds the pop until the
    push's copy ends.)"""
    for attempt in range(3):  # a descheduled consumer may miss once
        ring = tnative.FrameRing(2, BIG)
        ring.push(np.full(BIG, 7, np.uint8))
        th, box = _push_in_flight(ring, np.full(BIG, 9, np.uint8))
        out = np.empty(4096, np.uint8)
        t0 = time.perf_counter()
        rc = ring.pop(out)
        t1 = time.perf_counter()
        th.join(10)
        assert not th.is_alive()
        p0, p1, ok = box["push"]
        assert rc == 0 and ok and (out == 7).all()
        if t1 < p1 and t1 - t0 < (p1 - p0) / 2:
            break
        del ring
    else:
        pytest.fail(f"every pop waited for the push's copy: pop "
                    f"{(t1 - t0) * 1e3:.2f} ms, push {(p1 - p0) * 1e3:.2f}"
                    " ms")


def test_ring_close_while_a_push_copies(native_ring):
    """``close`` while a push's copy is in flight: the push succeeds, and
    its frame is drained whole before the end is reported."""
    ring = tnative.FrameRing(2, BIG)
    ring.push(np.full(BIG, 7, np.uint8))
    th, box = _push_in_flight(ring, np.full(BIG, 9, np.uint8))
    ring.close()
    head, out = np.empty(4096, np.uint8), np.empty(BIG, np.uint8)
    codes = [ring.pop(head)]  # quick: the push is still copying
    assert (head == 7).all()
    codes.append(ring.pop(out))
    assert (out == 9).all()
    codes.append(ring.pop(out, timeout_ms=1000))
    th.join(10)
    assert not th.is_alive() and box["push"][2]
    assert codes == [0, 0, -1]


@pytest.mark.parametrize("pool_above", [-1, 1 << 62])
def test_ring_close_while_a_pop_copies(native_ring, monkeypatch,
                                       pool_above):
    """``close`` while a pop's copy is in flight (on the pool and on the
    calling thread): that pop returns its frame whole, the frame behind
    it still drains, then -1."""
    from dips_tpu_torch.utils import staging
    monkeypatch.setattr(staging, "POOL_ABOVE", pool_above)
    monkeypatch.setattr(staging, "pool_threads", lambda: 4)
    ring = tnative.FrameRing(2, BIG)
    ring.push(np.full(BIG, 7, np.uint8))
    ring.push(np.full(BIG, 9, np.uint8))
    started = threading.Event()

    def closer():
        assert started.wait(10)
        time.sleep(0.002)
        ring.close()

    th = threading.Thread(target=closer)
    th.start()
    out = np.empty(BIG, np.uint8)  # fresh pages: a slow first copy
    started.set()
    codes = [ring.pop(out)]
    th.join(10)
    assert not th.is_alive()
    assert (out == 7).all()
    codes.append(ring.pop(out))
    assert (out == 9).all()
    codes.append(ring.pop(out, timeout_ms=1000))
    assert codes == [0, 0, -1]
    assert ring.pops == 2
    assert ring.pooled_pops == (2 if pool_above < 0 else 0)


def _dummy_so(path):
    src = str(path) + ".cpp"
    with open(src, "w") as f:
        f.write('extern "C" int fp_nothing() { return 0; }\n')
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(path), src],
                   check=True, capture_output=True)


@pytest.mark.skipif(not HAVE_TOOLCHAIN, reason="no g++ / make")
def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """A library from older sources (a symbol missing) is rebuilt from the
    port's sources; without sources to build from, the fallback is
    used instead of an import error."""
    shutil.copy(Path(tnative._DIR) / "framepump.cpp", tmp_path)
    shutil.copy(Path(tnative._DIR) / "Makefile", tmp_path)
    so = tmp_path / "libframepump.so"
    _dummy_so(so)
    late = max(os.path.getmtime(tmp_path / n)
               for n in ("framepump.cpp", "Makefile")) + 10
    os.utime(so, (late, late))
    monkeypatch.setattr(tnative, "_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_SO", str(so))
    lib = tnative._load()
    assert lib is not None and int(lib.fp_simd_level()) >= 0
    bare = tmp_path / "bare"
    bare.mkdir()
    _dummy_so(bare / "libframepump.so")
    monkeypatch.setattr(tnative, "_DIR", str(bare))
    monkeypatch.setattr(tnative, "_SO", str(bare / "libframepump.so"))
    assert tnative._load() is None


def test_no_native_env_forces_the_fallback(tmp_path):
    code = ("import dips_tpu_torch.native as n\n"
            "print(n.NATIVE_AVAILABLE, n.simd_level())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "DIPS_TPU_NO_NATIVE": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "-1"]


def _copy_of_native(dst: Path) -> Path:
    """A package ``pkg`` holding copies of the port's ``native`` (without
    its library) and ``utils``: building there never touches the library
    the rest of the suite is using."""
    pkg = dst / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    src = Path(tnative._DIR)
    shutil.copytree(src.parent / "utils", pkg / "utils",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "native").mkdir()
    for name in ("__init__.py", "framepump.cpp", "Makefile"):
        shutil.copy(src / name, pkg / "native" / name)
    return pkg


@pytest.mark.skipif(not HAVE_TOOLCHAIN, reason="no g++ / make")
def test_parallel_imports_each_get_the_library(tmp_path):
    """Six fresh processes import the module at once, with no library
    built yet: one builds under the directory lock, the others wait and
    load it; every one reports NATIVE_AVAILABLE and the same tier."""
    pkg = _copy_of_native(tmp_path)
    assert not (pkg / "native" / "libframepump.so").exists()
    code = ("import pkg.native as n\n"
            "print(n.NATIVE_AVAILABLE, n.simd_level())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "load failed" not in err and "stale" not in err, err
    assert {o.strip() for o, _ in outs} == {
        f"True {tnative.simd_level()}"}
    assert (pkg / "native" / "libframepump.so").exists()
