"""The checkpoint codec registry (the port of ``repro.runtime.compression``,
its codec half): byte-level compression for checkpoint blobs.

Each codec has JAX's name and format byte (zstd 2 at level 3, zlib 1 at
level 6, raw 0), so a blob's header byte picks the same decompressor in
either package.  Availability is probed lazily (importing this module needs
no optional wheel); the writer takes the best codec available (zstd ->
zlib -> raw) and records its byte in the header, so files round-trip
across environments with different codec sets.  A codec that is asked for
by name or by a header byte and is not installed raises; nothing falls
back.

The quantize / error-feedback half of JAX's module (``Compressed``,
``quantize``, ``ef_*``, ``compressed_psum``) is not ported yet: JAX's
runtime does not reach it (ROADMAP, Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

#: the zstd frame magic (RFC 8878 §3.1.1): legacy pre-header checkpoints
#: are bare zstd streams, so this is the only non-GVCK prefix the checkpoint
#: reader accepts; anything else is rejected as corrupt
LEGACY_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


@dataclasses.dataclass(frozen=True)
class CheckpointCodec:
    name: str
    fmt_byte: int                        # recorded in the checkpoint header
    available: Callable[[], bool]
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]


def _zstd_available() -> bool:
    try:
        import zstandard  # noqa: F401
        return True
    except ImportError:
        return False


def _zstd_compress(data: bytes) -> bytes:
    import zstandard

    return zstandard.ZstdCompressor(level=3).compress(data)


def _zstd_decompress(data: bytes) -> bytes:
    import zstandard

    return zstandard.ZstdDecompressor().decompress(data)


def _zlib_compress(data: bytes) -> bytes:
    import zlib

    return zlib.compress(data, 6)


def _zlib_decompress(data: bytes) -> bytes:
    import zlib

    return zlib.decompress(data)


#: priority order for auto-selection: zstd (optional wheel) -> zlib (stdlib)
#: -> raw (no compression)
CHECKPOINT_CODECS: tuple[CheckpointCodec, ...] = (
    CheckpointCodec("zstd", 2, _zstd_available, _zstd_compress, _zstd_decompress),
    CheckpointCodec("zlib", 1, lambda: True, _zlib_compress, _zlib_decompress),
    CheckpointCodec("raw", 0, lambda: True, lambda b: b, lambda b: b),
)

_BY_NAME = {c.name: c for c in CHECKPOINT_CODECS}
_BY_BYTE = {c.fmt_byte: c for c in CHECKPOINT_CODECS}


def get_codec(name: str) -> CheckpointCodec:
    """Codec by name; raises if it is unknown or not installed here."""
    if name not in _BY_NAME:
        raise KeyError(f"unknown checkpoint codec {name!r}; "
                       f"registered: {sorted(_BY_NAME)}")
    codec = _BY_NAME[name]
    if not codec.available():
        raise RuntimeError(
            f"checkpoint codec {name!r} is registered but unavailable in this "
            f"environment (optional dependency not installed)")
    return codec


def codec_for_byte(fmt_byte: int) -> CheckpointCodec:
    """Codec recorded in a checkpoint header (for the read path)."""
    if fmt_byte not in _BY_BYTE:
        raise ValueError(f"unknown checkpoint codec byte {fmt_byte}; "
                         f"registered: {sorted(_BY_BYTE)}")
    codec = _BY_BYTE[fmt_byte]
    if not codec.available():
        raise RuntimeError(
            f"checkpoint was written with codec {codec.name!r}, which is not "
            f"available here — install the optional dependency to restore it")
    return codec


def best_codec(preferred: Optional[str] = None) -> CheckpointCodec:
    """Auto-select by availability (zstd -> zlib -> raw), or force by name."""
    if preferred is not None:
        return get_codec(preferred)
    for codec in CHECKPOINT_CODECS:
        if codec.available():
            return codec
    raise RuntimeError("no checkpoint codec available")  # raw is always there
