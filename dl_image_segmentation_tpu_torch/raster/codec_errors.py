"""Kinds of codec failure that PIL's loader tells apart.

The port's codecs raise ``ValueError`` subclasses of their own
(``PNGError``, ``JPEGError``, ``BMPError``, ``GIFError``), which
``decode_image_bytes`` wraps in ``CorruptRasterError``. Where PIL,
loading the same bytes, raises a class or a message of its own, the
codec's error also derives from one of the kinds below, and
``pil_open.py`` maps on the kind.
"""

from __future__ import annotations

__all__ = ["NotEnoughImageData", "TruncatedData", "UnknownFilter"]


class TruncatedData(ValueError):
    """The data ends before the image is whole: PIL's ``OSError`` "image
    file is truncated"."""


class NotEnoughImageData(ValueError):
    """A run-length stream that ends before the image is whole: PIL's
    ``ValueError`` "not enough image data"."""


class UnknownFilter(ValueError):
    """A PNG row of an unknown filter type: PIL's ``OSError``
    "unrecognized data stream contents"."""
