"""The port's zstd decoder (``csrc/host/zstd.cc`` through
``storage/zstd.py``) against the ``zstandard`` package, on the CPU.

The decoder must give ``zstandard``'s bytes for every frame that
zstandard writes at levels 1-19 (and a fast negative level and the
ultra level 22): with and without a content size, with and without a
checksum, from 0 bytes to 3 MiB, for incompressible, text-like, float32
and run-heavy data, and for frames written back to back with skippable
frames between them. Corrupt input (truncated frames, flipped bits in a
checksummed frame's blocks, a frame that needs a dictionary) raises
``ZstdError``; it never crashes (the decoder was also fuzzed under
ASan/UBSan). ``compress_raw`` frames decode in ``zstandard``. Exact
equality throughout."""

import numpy as np
import pytest
import torch
import zstandard

from dl_image_segmentation_tpu_torch.storage import zstd

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)


def sample(kind: str, n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "text":
        words = [b"tile", b"chip", b"label", b"sentinel", b"band ", b"\n"]
        out = b"".join(words[i] for i in rng.integers(0, 6, n // 3 + 1))
        return out[:n]
    if kind == "float32":
        w = rng.standard_normal(n // 4 + 1).astype(np.float32) * 0.02
        return w.tobytes()[:n]
    # runs and repeats: long matches, repeat offsets, RLE blocks
    unit = rng.integers(0, 4, 97, dtype=np.uint8).tobytes()
    runs = bytes(rng.integers(0, 3, n // 64 + 1, dtype=np.uint8)) * 64
    return (unit * (n // 97 + 1))[: n // 2] + runs[: n - n // 2]


KINDS = ["random", "text", "float32", "runs"]
SIZES = [0, 1, 100, 5000, 140_000]


@pytest.mark.parametrize("level", list(range(1, 20)) + [-5, 22])
def test_levels_equal_zstandard(level):
    for k, kind in enumerate(KINDS):
        for n in SIZES:
            data = sample(kind, n, seed=abs(level) * 100 + k)
            for checksum in (False, True):
                frame = zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum,
                    write_content_size=bool(n % 2)).compress(data)
                assert zstd.decompress(frame, max(n, 1)) == data, \
                    (kind, n, checksum)


@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_megabytes_equal_zstandard(level):
    data = sample("float32", 2 << 20, 1) + sample("runs", 1 << 20, 2)
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.content_size(frame) == len(data)
    assert zstd.decompress(frame, len(data)) == data


def test_streamed_frames_without_content_size_grow_the_output():
    data = sample("text", 600_000, 3)
    cctx = zstandard.ZstdCompressor(level=3, write_checksum=True)
    obj = cctx.compressobj()
    frame = obj.compress(data) + obj.flush()
    assert zstd.content_size(frame) == -1
    assert zstd.decompress(frame, len(data)) == data


def test_concatenated_and_skippable_frames():
    parts = [sample(k, 3000 * (i + 1), i) for i, k in enumerate(KINDS)]
    frames = []
    for i, p in enumerate(parts):
        frames.append(zstandard.ZstdCompressor(level=2 * i + 1,
                                               write_checksum=i % 2 == 0)
                      .compress(p))
        # a skippable frame (magic 0x184D2A5?, length, payload)
        frames.append(bytes([0x50 + i, 0x2A, 0x4D, 0x18, 3, 0, 0, 0])
                      + b"abc")
    stream = b"".join(frames)
    assert zstd.decompress(stream, sum(map(len, parts))) == b"".join(parts)
    assert zstd.content_size(stream) == sum(map(len, parts))


def test_raw_frames_round_trip_through_zstandard():
    for n in (0, 1, 255, 256, 65791, 65792, 131072, 300_001):
        data = sample("random", n, n)
        for checksum in (False, True):
            frame = zstd.compress_raw(data, checksum)
            assert zstandard.ZstdDecompressor().decompress(frame) == data
            assert zstd.decompress(frame, max(n, 1)) == data


def test_xxh64_is_the_frame_checksum():
    for n in (0, 3, 31, 32, 33, 1000):
        data = sample("text", n, n)
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert int.from_bytes(frame[-4:], "little") == \
            zstd.xxh64(data) & 0xFFFFFFFF
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


def header_size(frame) -> int:
    """Magic, frame header descriptor, window descriptor, dictionary id
    and content size: a flip there may leave a valid frame."""
    fhd = frame[4]
    single, fcs = (fhd >> 5) & 1, fhd >> 6
    return (5 + (not single) + (0, 1, 2, 4)[fhd & 3]
            + ((single, 2, 4, 8)[fcs]))


def test_truncated_frames_raise():
    data = sample("float32", 50_000, 7)
    frame = zstandard.ZstdCompressor(level=5, write_checksum=True) \
        .compress(data)
    for cut in list(range(0, 40)) + list(range(40, len(frame), 97)):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut], len(data))


@pytest.mark.parametrize("level", [1, 6, 19])
def test_flipped_bits_in_checksummed_blocks_raise(level):
    rng = np.random.default_rng(level)
    for kind in KINDS:
        data = sample(kind, 20_000, level)
        frame = bytearray(zstandard.ZstdCompressor(
            level=level, write_checksum=True).compress(data))
        for _ in range(60):
            bad = bytearray(frame)
            pos = int(rng.integers(header_size(frame), len(bad)))
            bad[pos] ^= 1 << int(rng.integers(0, 8))
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(bytes(bad), len(data) * 2)


def test_corrupt_input_never_crashes():
    """Truncations, flips and byte stores anywhere (header included),
    without a checksum: a result or ZstdError, never a crash."""
    rng = np.random.default_rng(11)
    frames = [zstandard.ZstdCompressor(level=lv).compress(sample(k, 9000, lv))
              for lv in (1, 4, 12) for k in KINDS]
    for i in range(2000):
        bad = bytearray(frames[i % len(frames)])
        for _ in range(int(rng.integers(1, 6))):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        try:
            out = zstd.decompress(bytes(bad[: int(rng.integers(1, len(bad)
                                                                + 1))]),
                                  20_000)
        except zstd.ZstdError:
            continue
        assert len(out) <= 20_000


def test_dictionary_frames_and_oversized_content_raise():
    samples = [sample("text", 500, s) for s in range(64)]
    d = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[0])
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(frame, 1000)
    frame = zstandard.ZstdCompressor().compress(bytes(5000))
    with pytest.raises(zstd.ZstdError, match="exceeds"):
        zstd.decompress(frame, 4999)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(b"", 10)
    with pytest.raises(ValueError, match="negative"):
        zstd.decompress(frame, -1)
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"PK\x03\x04 not zstd", 10)
