"""Host audio I/O: WAV read/write (native C++ fast path, scipy fallback)."""

from .wav import read_wav, write_wav  # noqa: F401
