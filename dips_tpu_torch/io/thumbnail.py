"""Thumbnail extraction: first frame -> fixed-height preview image.

Parity with the reference's GStreamer thumbnail pipeline
(dips/src/thumbnail_extractor.rs:63-168): grab the first decodable frame,
downscale to height 240 preserving aspect, save.  The source goes through
the backend-selecting reader, so media URIs work too — a fleet dashboard
can thumbnail ``rtsp://cam/...`` directly.
"""

from __future__ import annotations

import cv2
import numpy as np

from ..errors import DecodeError, EncodeError

THUMBNAIL_HEIGHT = 240  # ref: dips/src/thumbnail_extractor.rs:130-151


def extract_thumbnail(input_path: str, output_path: str,
                      height: int = THUMBNAIL_HEIGHT,
                      backend: str = "auto") -> np.ndarray:
    """Save a thumbnail of ``input_path``'s first frame; returns it (RGB)."""
    from .gstreamer import open_video
    with open_video(input_path, backend) as r:
        frame = r.read()
    if frame is None:
        raise DecodeError(f"no decodable frame in {input_path}")
    h, w = frame.shape[:2]
    scale = height / h
    # INTER_AREA is only right for downscales; it degrades to blocky
    # nearest-neighbour when enlarging
    interp = cv2.INTER_AREA if scale <= 1.0 else cv2.INTER_LINEAR
    thumb = cv2.resize(frame, (max(1, int(round(w * scale))), height),
                       interpolation=interp)
    try:
        ok = cv2.imwrite(output_path, cv2.cvtColor(thumb, cv2.COLOR_RGB2BGR))
    except cv2.error as e:  # unknown extension RAISES rather than False
        raise EncodeError(f"could not write thumbnail: {output_path} "
                          f"({e})") from None
    if not ok:
        raise EncodeError(f"could not write thumbnail: {output_path}")
    return thumb
