"""denoise_fft_roofline: the denoise's transforms' share of their
roofline: the least time of a batch's transforms
(``roofline_post.denoise_transforms``: 24 bytes a pixel of each plane
over 3.35 TB/s) over the device time a batch of cuFFT's kernels in the
traced stretch, in %.  The batches and planes are the engine's denoise
counters' over the same stretch; without them (an engine that keeps
none) the metric is left out.

cuFFT's kernels are matched by name: on the card (NVIDIA H100 80GB HBM3,
CUDA 12.8, PyTorch 2.11) a 4K batch runs 32 launches each of
``void regular_fft<2160u, EPT<6u, 10u>, ...>`` (the columns) and
``void vector_fft<3840u, EPT<15u>, ...>`` (the rows), a forward and an
inverse transform a frame, and no other kernel of the cell has ``fft`` in
its name.  PyTorch's own kernels (``at::native::...``: the copies to
complex, the mask's product, ``abs``, the rounding) are not cuFFT's and
are left out by name.
"""

from portbench.roofline_post import denoise_transforms
from portbench.trace import clip


def is_cufft(name: str) -> bool:
    return "fft" in name.lower() and "at::native" not in name


def read(run):
    c = (run.timers or {}).get("denoise")
    if not run.traced or not c or not c["batches"]:
        return None
    iv = clip(run.device_iv, run.trace_lo, run.trace_hi)
    busy = sum(b - a for n, a, b in iv if is_cufft(n))
    if busy <= 0:
        return None
    cfg = run.config
    least = denoise_transforms(int(cfg["height"]), int(cfg["width"]),
                               c["planes"])["least_s"]
    return 100.0 * least / (busy / 1e6)
