"""The port's zstd decoder (``csrc/zstd_decode.cpp`` through
``utils/zstd.py``) against libzstd through the ``zstandard`` package, and
its CRC-32C against ``google_crc32c``: frames of
every level from -5 to 22, with and without content size and checksum,
long-distance matching, concatenated and skippable frames, empty content,
random and compressible data; a walk of the frames' headers shows every
block, literals and sequence mode occurs; and a seeded mutation fuzz where
each damaged frame decodes to libzstd's bytes or raises in both."""
import numpy as np
import pytest

zstandard = pytest.importorskip("zstandard")

from citlab_as_tpu_torch.utils import zstd  # noqa: E402

LEVELS = (-5, 1, 3, 9, 19, 22)
KINDS = ("random", "text", "floats", "skewed", "runs")


def _data(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "text":
        words = [b"alpha ", b"beta ", b"gamma ", b"delta\n", b"0123456789", b"zstd ", b"ocdbt/"]
        return b"".join(words[i] for i in rng.integers(0, len(words), n // 3 + 1))[:n]
    if kind == "floats":
        return (rng.standard_normal(n // 4 + 1).astype(np.float32) * 0.01).tobytes()[:n]
    if kind == "skewed":
        return rng.geometric(0.3, n).astype(np.uint8).tobytes()
    runs = np.repeat(rng.integers(0, 4, n // 50 + 1, dtype=np.uint8), 50)
    return runs.tobytes()[:n]


def _libzstd(frame: bytes) -> bytes:
    """libzstd's decode of one frame, trailing bytes refused; a frame that
    gives its content size as 0 is decoded as a stream (the binding's
    one-shot call returns b"" for it without decoding), one that gives more
    than 64 MiB is refused (libzstd's content check would refuse it)."""
    try:
        size = zstandard.get_frame_parameters(frame).content_size
    except zstandard.ZstdError:
        size = None
    if size == 0:
        obj = zstandard.ZstdDecompressor().decompressobj()
        out = obj.decompress(frame)
        if obj.unused_data or not obj.eof:
            raise ValueError("data after the frame, or the frame cut short")
        return out
    if size is not None and size > 1 << 26 and size != zstandard.CONTENTSIZE_UNKNOWN:
        # no frame here holds that much (the binding would first allocate it)
        raise ValueError("content size past any frame of these tests")
    out = zstandard.ZstdDecompressor().decompress(frame, max_output_size=1 << 26,
                                                  allow_extra_data=False)
    obj = zstandard.ZstdDecompressor().decompressobj()
    try:
        obj.decompress(frame)
    except zstandard.ZstdError:
        return out
    if obj.unused_data:
        raise ValueError("data after the frame")
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
def test_frames_of_every_level_decode_as_libzstd(level, kind):
    for n, seed in ((0, 0), (1, 1), (100, 2), (5000, 3), (70000, 4), (300000, 5)):
        data = _data(kind, n, seed + 10 * LEVELS.index(level))
        for size, check in ((True, False), (False, True), (True, True)):
            frame = zstandard.ZstdCompressor(level=level, write_content_size=size,
                                             write_checksum=check).compress(data)
            assert zstd.decompress(frame) == data, (n, size, check)


def test_long_distance_matching_frames():
    rng = np.random.default_rng(7)
    block = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    data = block + rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes() + block
    params = zstandard.ZstdCompressionParameters.from_level(
        3, enable_ldm=True, window_log=23, ldm_hash_log=20, write_checksum=True)
    frame = zstandard.ZstdCompressor(compression_params=params).compress(data)
    assert len(frame) < len(data) - (1 << 19)   # the far repeat was matched
    assert zstd.decompress(frame) == data


def test_concatenated_skippable_and_empty_frames():
    parts = [_data("text", 4000, 1), b"", _data("random", 3000, 2), _data("runs", 9000, 3)]
    frames = [zstandard.ZstdCompressor(level=3).compress(p) for p in parts]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    blob = frames[0] + skip + frames[1] + frames[2] + skip + frames[3]
    assert zstd.decompress(blob) == b"".join(parts)
    assert zstd.decompress(frames[1]) == b""
    assert zstd.decompress(skip + frames[1]) == b""
    for bad in (b"", skip[:6], frames[0] + b"\x00", frames[0][:-1], b"\x28\xb5\x2f"):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bad)


@pytest.mark.parametrize("size", [True, False])
def test_a_frame_naming_a_dictionary_is_refused_as_libzstd_refuses_it(size):
    """No dictionary is loaded: a frame whose header names one (a nonzero
    ID of 1, 2 or 4 bytes) is refused by both; an ID of 0 names none."""
    data = _data("text", 600, 5)
    frame = zstandard.ZstdCompressor(level=3, write_content_size=size).compress(data)
    fhd = frame[4]
    at = 5 if (fhd >> 5) & 1 else 6
    for flag, dict_id in ((1, b"\x07"), (2, b"\x07\x00"), (3, b"\x00\x00\x00\x80"),
                          (1, b"\x00")):
        named = frame[:4] + bytes([(fhd & ~3) | flag]) + frame[5:at] + dict_id + frame[at:]
        if any(dict_id):
            with pytest.raises(zstandard.ZstdError, match="Dictionary mismatch"):
                _libzstd(named)
            with pytest.raises(zstd.ZstdError, match="dictionary"):
                zstd.decompress(named)
        else:
            assert zstd.decompress(named) == _libzstd(named) == data


def test_crc32c_matches_google_crc32c():
    crc = pytest.importorskip("google_crc32c")
    rng = np.random.default_rng(0)
    for n in (0, 1, 3, 7, 8, 9, 31, 32, 33, 100, 4096, 100001):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert zstd.crc32c(data) == crc.value(data)


def test_content_checksum_is_checked():
    """XXH64's low 32 bits close a frame that flags a checksum: every byte
    count from 0 to 80 (XXH64's 32-byte stripes and its 8-, 4- and 1-byte
    tails) decodes, and a frame whose checksum is changed is refused by
    both."""
    rng = np.random.default_rng(9)
    for n in range(81):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
        assert zstd.decompress(frame) == data
        bad = frame[:-1] + bytes([frame[-1] ^ 1])
        with pytest.raises(zstd.ZstdError, match="checksum"):
            zstd.decompress(bad)
        with pytest.raises(zstandard.ZstdError):
            _libzstd(bad)


def _modes(frame: bytes, seen: set) -> None:
    """Walk one frame's headers: block types, literals types, stream counts,
    Huffman weight encodings and the three sequence modes."""
    fhd = frame[4]
    single, fcs_flag, did = (fhd >> 5) & 1, fhd >> 6, fhd & 3
    at = 5 + (0 if single else 1) + (0, 1, 2, 4)[did]
    at += (1 if single else 0) if fcs_flag == 0 else 1 << fcs_flag
    while True:
        bh = int.from_bytes(frame[at:at + 3], "little")
        last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
        at += 3
        seen.add(("block", ("raw", "rle", "compressed")[btype]))
        if btype == 2:
            b = frame[at:at + size]
            ltype, lfmt = b[0] & 3, (b[0] >> 2) & 3
            seen.add(("literals", ("raw", "rle", "compressed", "treeless")[ltype]))
            if ltype < 2:
                hs = (1, 2, 1, 3)[lfmt]
                lsize = (int.from_bytes(b[:3], "little") >> (3 if hs == 1 else 4)) & (
                    (1 << (5, 12, 5, 20)[lfmt]) - 1)
                used = hs + (lsize if ltype == 0 else 1)
            else:
                hs = (3, 3, 4, 5)[lfmt]
                h = int.from_bytes(b[:5], "little")
                csize = (h >> (14, 14, 18, 22)[lfmt]) & ((1 << (10, 10, 14, 18)[lfmt]) - 1)
                used = hs + csize
                seen.add(("streams", 1 if lfmt == 0 else 4))
                if ltype == 2:
                    seen.add(("weights", "fse" if b[hs] < 128 else "direct"))
            nseq = b[used]
            used += 1 if nseq < 128 else (2 if nseq < 255 else 3)
            if nseq:
                m = b[used]
                for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
                    seen.add((name, ("predefined", "rle", "fse", "repeat")[(m >> shift) & 3]))
        at += 1 if btype == 1 else size
        if last:
            return


def test_every_block_literals_and_sequence_mode_occurs():
    seen: set = set()
    corpus = []
    for level in LEVELS:
        for kind in KINDS:
            data = _data(kind, 200000, LEVELS.index(level))
            corpus.append((level, data))
    small = b"abcabcabd" * 3 + bytes(range(40)) + b"xyxyxyxy"
    corpus += [(19, small), (1, bytes(300000)), (3, b"ab" * 50 + bytes(range(256)) * 2),
               (3, (b"a" * 7 + b"bc") * 4000), (19, bytes(range(16)) * 2000)]
    frames = [(zstandard.ZstdCompressor(level=level).compress(data), data)
              for level, data in corpus]
    # libzstd writes RLE literals only for a block of 63 or more equal
    # literals that no match covers; one such block written by hand
    # (single segment, content size 100, RLE literals "q" x 100, no sequences)
    lit = bytes([0x01 | (1 << 2) | ((100 & 0xF) << 4), 100 >> 4]) + b"q" + b"\x00"
    block = ((len(lit) << 3) | (2 << 1) | 1).to_bytes(3, "little") + lit
    frame = (0xFD2FB528).to_bytes(4, "little") + bytes([0x20, 100]) + block
    assert _libzstd(frame) == b"q" * 100
    frames.append((frame, b"q" * 100))
    for frame, data in frames:
        _modes(frame, seen)
        assert zstd.decompress(frame) == data
    want = {("block", b) for b in ("raw", "rle", "compressed")}
    want |= {("literals", t) for t in ("raw", "rle", "compressed", "treeless")}
    want |= {("streams", 1), ("streams", 4), ("weights", "fse"), ("weights", "direct")}
    want |= {(s, m) for s in ("ll", "of", "ml") for m in ("predefined", "rle", "fse", "repeat")}
    assert want <= seen, sorted(want - seen)


@pytest.mark.parametrize("seed", range(8))
def test_damaged_frames_decode_as_libzstd_or_raise_in_both(seed):
    """Bit flips, byte overwrites (anywhere, in the header, in the first
    blocks) and cuts: each damaged frame decodes to libzstd's bytes or
    both refuse it."""
    rng = np.random.default_rng(1000 + seed)
    agree = {"ok": 0, "raise": 0}
    for _ in range(60):
        level = int(rng.choice(LEVELS))
        kind = str(rng.choice(KINDS))
        n = int(rng.choice([10, 100, 1000, 5000, 40000]))
        frame = bytearray(zstandard.ZstdCompressor(
            level=level, write_content_size=bool(rng.integers(2)),
            write_checksum=bool(rng.integers(2))).compress(_data(kind, n, int(rng.integers(99)))))
        how = int(rng.integers(5))
        if how == 0:
            for _ in range(int(rng.integers(1, 4))):
                frame[int(rng.integers(len(frame)))] ^= 1 << int(rng.integers(8))
        elif how == 1:
            frame[int(rng.integers(len(frame)))] = int(rng.integers(256))
        elif how == 2:
            frame = frame[:int(rng.integers(len(frame)))]
        elif how == 3:
            frame[int(rng.integers(min(len(frame), 40)))] = int(rng.integers(256))
        else:
            lo = min(9, len(frame) - 1)
            frame[int(rng.integers(lo, max(lo + 1, len(frame) // 20)))] ^= 1 << int(rng.integers(8))
        frame = bytes(frame)
        try:
            want = _libzstd(frame)
        except (zstandard.ZstdError, ValueError):
            want = None
        try:
            got = zstd.decompress(frame)
        except zstd.ZstdError:
            got = None
        assert got == want, (level, kind, n, how, frame[:16].hex())
        agree["raise" if want is None else "ok"] += 1
    assert agree["raise"] > 0 and agree["ok"] > 0
