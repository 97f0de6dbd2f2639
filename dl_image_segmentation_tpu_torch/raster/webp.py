"""WebP decoding of the port (no PIL): ``csrc/host/webp.cc``, built with
g++ into ``build/`` at first use and called through ctypes.

PIL 12.1 opens WebP through libwebp's ``WebPAnimDecoder``: the RIFF
container must be whole and valid, or ``Image.open`` raises ``OSError``
"could not create decoder object"; a bitstream that then fails to
decode raises ``OSError`` "failed to read next frame" when the pixels
are read. The mode is RGBA when ``WebPGetFeatures`` reports alpha (the
VP8X flag, a VP8L header's alpha bit, an ALPH chunk), RGB otherwise;
the pixels are the first frame on its canvas, as libwebp decodes them
(see the source's header).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build
from .pil_formats import Opened

__all__ = ["decode_webp_rgba", "open_webp", "webp_info"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "webp.cc")
_CMD = ("g++", "-O2", "-shared", "-fPIC", "-std=c++17")
_SIGNATURES = {
    "fc_webp_info": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_void_p]),
    "fc_webp_decode": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_void_p, ctypes.c_int32,
                                      ctypes.c_int32]),
}


def _lib():
    return _build.load(_CMD, _SRC, _SIGNATURES)


def webp_info(data: bytes):
    """(width, height, has_alpha) of the canvas, or None when PIL's
    decoder would not open the data."""
    info = np.zeros(3, np.int32)
    if _lib().fc_webp_info(data, len(data), info.ctypes.data):
        return None
    return int(info[0]), int(info[1]), bool(info[2])


def decode_webp_rgba(data: bytes) -> np.ndarray:
    """WebP bytes -> (H, W, 4) uint8, the canvas libwebp's
    ``WebPAnimDecoder`` gives for the first frame (``OSError`` as PIL's
    decoder raises it)."""
    info = webp_info(data)
    if info is None:
        raise OSError("could not create decoder object")
    w, h, _ = info
    out = np.empty((h, w, 4), np.uint8)
    rc = _lib().fc_webp_decode(data, len(data), out.ctypes.data, w, h)
    if rc == 1:
        raise OSError("could not create decoder object")
    if rc:
        raise OSError("failed to read next frame")
    return out


def open_webp(data: bytes) -> Opened:
    """``WebPImageFile._open``: the decoder object is made at open."""
    info = webp_info(data)
    if info is None:
        raise OSError("could not create decoder object")
    w, h, alpha = info

    def load():
        rgba = decode_webp_rgba(data)
        return rgba if alpha else np.ascontiguousarray(rgba[:, :, :3])
    return Opened("WEBP", "RGBA" if alpha else "RGB", (w, h), load)
