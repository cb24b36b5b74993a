"""Native (C++) host components, loaded with ctypes.

Counterpart of ``sphfluidsimulation_tpu/native``. Built on demand with g++;
every consumer has a numpy fallback, so the package works without a
toolchain. This is a host helper of the frame export, not a kernel of the
card.
"""

from .build import load_framecodec  # noqa: F401
