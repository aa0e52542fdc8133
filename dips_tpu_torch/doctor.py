"""Environment diagnosis: one command that answers "why is this host
slow / failing?" before reading any logs.

    python -m dips_tpu_torch.doctor [--json] [--timeout S]

Counterpart of ``dips_tpu/doctor.py``, with the same sections, flags and
exit codes but for the card: ``torch`` (version, CUDA, the card's name,
count and power limit), ``native`` (the framepump host module: SIMD
layout kernels or the numpy fallback), ``opencv``, ``gstreamer``,
``kernels`` (the nvcc that builds the CUDA kernels, and whether the
library for the current sources is built) and ``report`` (matplotlib).
Each line names the knob to fix it.  Exit code 1 when a section is not
ok (no card, no native module, neither nvcc nor a built library).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading


def _power_line() -> str | None:
    """``name, power.limit`` of the first card as nvidia-smi prints them,
    or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _probe_torch(timeout_s: float) -> dict:
    """Card probe under a watchdog: a wedged driver can block CUDA's
    initialisation for good, so it runs in a daemon thread and a hang is
    reported instead of inherited.  ok only with a card."""
    import torch

    box: dict = {}

    def probe():
        try:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            box.update(devices=n,
                       device_name=torch.cuda.get_device_name(0) if n
                       else None)
        except Exception as e:  # noqa: BLE001 - diagnosis, not control flow
            box["error"] = repr(e)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    base = {"version": torch.__version__, "cuda": torch.version.cuda}
    if t.is_alive():
        return {**base, "devices": 0, "device_name": None, "ok": False,
                "hint": f"CUDA init did not answer within {timeout_s:g}s: "
                        f"driver wedged? (runs would hang - check "
                        f"nvidia-smi)"}
    if "error" in box:
        return {**base, "devices": 0, "device_name": None, "ok": False,
                "hint": f"CUDA init failed: {box['error']}"}
    ok = box["devices"] > 0
    return {
        **base, **box, "power": _power_line() if ok else None, "ok": ok,
        "hint": None if ok else
            "no CUDA card: every entry point needs --device cpu (the "
            "kernels' plain PyTorch twins, far slower)",
    }


def collect(timeout_s: float = 60.0) -> dict:
    """Gather the report as a dict (importable for tests and tools).

    Each section is guarded: a broken component is reported as such
    (``ok: false`` + ``error``) rather than crashing the diagnosis -- the
    broken hosts are the ones that need the doctor."""
    info: dict = {}

    def section(name, fn):
        try:
            info[name] = fn()
        except Exception as e:  # noqa: BLE001 - diagnosis, not control flow
            info[name] = {"ok": False, "error": repr(e),
                          "hint": f"section crashed: {e!r}"}

    section("torch", lambda: _probe_torch(timeout_s))

    def _native():
        from . import native
        lvl = native.simd_level()
        return {
            "available": native.NATIVE_AVAILABLE,
            "simd": native.SIMD_NAMES.get(lvl, str(lvl)),
            "ok": native.NATIVE_AVAILABLE,
            "hint": None if native.NATIVE_AVAILABLE else
                "native module not built (no toolchain?): host layout "
                "transforms fall back to numpy (~3x slower at 1080p)",
        }

    section("native", _native)

    def _opencv():
        import cv2
        return {"version": cv2.__version__, "ok": True, "hint": None}

    section("opencv", _opencv)

    def _gst():
        from .io import gstreamer
        return {
            "available": gstreamer.available(),
            "ok": True,  # optional either way
            "hint": None if gstreamer.available() else
                "GStreamer absent: OpenCV/FFmpeg handles files and URIs; "
                "PTS-preserving avimux egress unavailable",
        }

    section("gstreamer", _gst)

    def _kernels():
        from .ops import _build
        try:
            nvcc = _build._nvcc()
        except RuntimeError:
            nvcc = None
        out_dir = _build.BUILD_ROOT / _build.build_key(
            _build.network_header())
        built = (out_dir / _build.LIB_NAME).exists()
        return {
            "nvcc": nvcc, "dir": str(out_dir), "built": built,
            "ok": built or nvcc is not None,
            "hint": None if built else
                "CUDA kernels not built for these sources: the first run "
                "on the card builds them (nvcc, about 20 s)" if nvcc else
                "no nvcc (set CUDA_HOME or put nvcc on PATH) and no built "
                "library: the CUDA kernels cannot run",
        }

    section("kernels", _kernels)

    def _report():
        try:
            import matplotlib
            return {"matplotlib": matplotlib.__version__, "ok": True,
                    "hint": None}
        except ImportError:
            return {"matplotlib": None, "ok": True,  # optional extra
                    "hint": "matplotlib absent: dips-torch-report and "
                            "--heatmap-png unavailable (pip install "
                            "'dips-tpu[report]')"}

    section("report", _report)
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dips-torch-doctor", description="environment diagnosis")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    ap.add_argument("--timeout", type=float, default=60.0, metavar="S",
                    help="seconds to wait for CUDA init before declaring "
                         "the card unreachable")
    args = ap.parse_args(argv)
    info = collect(timeout_s=args.timeout)
    if args.json:
        print(json.dumps(info))
    else:
        for section, d in info.items():
            mark = "ok" if d.get("ok") else "!!"
            detail = ", ".join(f"{k}={v}" for k, v in d.items()
                               if k not in ("ok", "hint") and v is not None)
            print(f"[{mark}] {section}: {detail}")
            if d.get("hint"):
                print(f"     -> {d['hint']}")
    bad = [s for s, d in info.items() if not d.get("ok")]
    if bad:
        # non-zero so health-check scripts see the failure, not just a
        # human reading stderr
        print(f"attention: {', '.join(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
