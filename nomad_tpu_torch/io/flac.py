"""FLAC decoder in pure Python and numpy.

A copy of ``nomad_tpu.io.flac`` (the port imports nothing of the JAX
package); the tests hold it to the original bit for bit. LibriSpeech, the
NOMAD training corpus, ships as FLAC; this decoder (and its C++ twin in
``native/flac_decoder.cpp``, bound by ``io/native.py``) reads it without
an ffmpeg pass.

Covers STREAMINFO, frame sync, UTF-8 frame numbers, all four subframe
types (constant, verbatim, fixed order 0-4, LPC order 1-32), rice/rice2
residual partitions with escape codes, wasted bits, and the four stereo
decorrelation modes (independent, left/side, right/side, mid/side). CRCs
are read and not checked.

Returns int32 samples at the stream's bit depth; :func:`read_flac` scales
to float32 [-1, 1] as the WAV reader does (x / 2^(bits-1)).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


class FlacFormatError(ValueError):
    pass


@dataclass
class StreamInfo:
    min_block: int
    max_block: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int


class BitReader:
    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.bit = 0

    def align(self):
        if self.bit:
            self.pos += 1
            self.bit = 0

    def read_uint(self, n: int) -> int:
        out = 0
        pos, bit, data = self.pos, self.bit, self.data
        while n > 0:
            if pos >= len(data):
                raise FlacFormatError("unexpected end of stream")
            avail = 8 - bit
            take = min(avail, n)
            byte = data[pos]
            out = (out << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            bit += take
            n -= take
            if bit == 8:
                pos += 1
                bit = 0
        self.pos, self.bit = pos, bit
        return out

    def read_int(self, n: int) -> int:
        v = self.read_uint(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        count = 0
        pos, bit, data = self.pos, self.bit, self.data
        while True:
            if pos >= len(data):
                raise FlacFormatError("unexpected end of stream in unary")
            byte = data[pos]
            rest = byte & ((1 << (8 - bit)) - 1)
            if rest == 0:
                count += 8 - bit
                pos += 1
                bit = 0
                continue
            # position of highest set bit within the remaining bits
            top = rest.bit_length()  # 1..8-bit
            zeros = (8 - bit) - top
            count += zeros
            bit += zeros + 1  # consume the terminating 1
            if bit == 8:
                pos += 1
                bit = 0
            self.pos, self.bit = pos, bit
            return count


FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def parse_stream_info(data: bytes) -> tuple[StreamInfo, int]:
    """Returns (StreamInfo, offset of first frame)."""
    if data[:4] != b"fLaC":
        raise FlacFormatError("missing fLaC marker")
    pos = 4
    info = None
    while True:
        if pos + 4 > len(data):
            raise FlacFormatError("truncated metadata")
        header = data[pos]
        last = bool(header & 0x80)
        btype = header & 0x7F
        (length,) = struct.unpack(">I", b"\x00" + data[pos + 1 : pos + 4])
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:  # STREAMINFO
            br = BitReader(bytes(body))
            min_block = br.read_uint(16)
            max_block = br.read_uint(16)
            br.read_uint(24)  # min frame size
            br.read_uint(24)  # max frame size
            sample_rate = br.read_uint(20)
            channels = br.read_uint(3) + 1
            bits = br.read_uint(5) + 1
            total = br.read_uint(36)
            info = StreamInfo(min_block, max_block, sample_rate, channels,
                              bits, total)
        pos += 4 + length
        if last:
            break
    if info is None:
        raise FlacFormatError("missing STREAMINFO")
    return info, pos


_BLOCKSIZE_TABLE = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192,
    14: 16384, 15: 32768,
}

_RATE_TABLE = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}

_SIZE_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _read_utf8_number(br: BitReader) -> int:
    b0 = br.read_uint(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x80
    while b0 & mask:
        n += 1
        mask >>= 1
    val = b0 & (mask - 1)
    for _ in range(n - 1):
        val = (val << 6) | (br.read_uint(8) & 0x3F)
    return val


def _decode_residual(br: BitReader, blocksize: int, order: int) -> list[int]:
    method = br.read_uint(2)
    if method > 1:
        raise FlacFormatError(f"reserved residual method {method}")
    plen = 5 if method == 1 else 4
    escape = (1 << plen) - 1
    po = br.read_uint(4)
    nparts = 1 << po
    if blocksize % nparts:
        raise FlacFormatError("partition size mismatch")
    out: list[int] = []
    for p in range(nparts):
        count = (blocksize >> po) - (order if p == 0 else 0)
        param = br.read_uint(plen)
        if param == escape:
            raw_bits = br.read_uint(5)
            if raw_bits == 0:
                out.extend([0] * count)
            else:
                out.extend(br.read_int(raw_bits) for _ in range(count))
        else:
            for _ in range(count):
                q = br.read_unary()
                r = br.read_uint(param) if param else 0
                v = (q << param) | r
                out.append((v >> 1) ^ -(v & 1))  # zigzag
    return out


def _decode_subframe(br: BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read_uint(1) != 0:
        raise FlacFormatError("invalid subframe padding bit")
    stype = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if stype == 0:  # constant
        v = br.read_int(bps)
        samples = np.full(blocksize, v, np.int64)
    elif stype == 1:  # verbatim
        samples = np.fromiter(
            (br.read_int(bps) for _ in range(blocksize)), np.int64, blocksize
        )
    elif 8 <= stype <= 12:  # fixed
        order = stype - 8
        warm = [br.read_int(bps) for _ in range(order)]
        resid = _decode_residual(br, blocksize, order)
        coeffs = FIXED_COEFFS[order]
        s = list(warm)
        for i in range(order, blocksize):
            pred = 0
            for j, c in enumerate(coeffs):
                pred += c * s[i - 1 - j]
            s.append(pred + resid[i - order])
        samples = np.asarray(s if order else resid, np.int64)
    elif stype >= 32:  # LPC
        order = stype - 31
        warm = [br.read_int(bps) for _ in range(order)]
        precision = br.read_uint(4) + 1
        if precision == 16:
            raise FlacFormatError("invalid LPC precision escape")
        shift = br.read_int(5)
        coeffs = [br.read_int(precision) for _ in range(order)]
        resid = _decode_residual(br, blocksize, order)
        s = list(warm)
        for i in range(order, blocksize):
            acc = 0
            for j in range(order):
                acc += coeffs[j] * s[i - 1 - j]
            s.append((acc >> shift) + resid[i - order])
        samples = np.asarray(s, np.int64)
    else:
        raise FlacFormatError(f"reserved subframe type {stype}")

    if wasted:
        samples = samples << wasted
    return samples


def decode_flac_bytes(data: bytes) -> tuple[np.ndarray, int, int]:
    """Decode a FLAC byte buffer -> (int32 [channels, samples], sample_rate,
    bits_per_sample)."""
    info, pos = parse_stream_info(data)
    br = BitReader(data, pos)
    channels_out: list[list[np.ndarray]] = [[] for _ in range(info.channels)]
    total = 0

    while br.pos < len(data) - 2:
        br.align()
        sync = br.read_uint(14)
        if sync != 0x3FFE:
            raise FlacFormatError(f"lost frame sync at byte {br.pos}")
        br.read_uint(1)  # reserved
        br.read_uint(1)  # blocking strategy
        bs_code = br.read_uint(4)
        sr_code = br.read_uint(4)
        ch_code = br.read_uint(4)
        size_code = br.read_uint(3)
        br.read_uint(1)  # reserved
        _read_utf8_number(br)

        if bs_code == 6:
            blocksize = br.read_uint(8) + 1
        elif bs_code == 7:
            blocksize = br.read_uint(16) + 1
        elif bs_code in _BLOCKSIZE_TABLE:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        else:
            raise FlacFormatError(f"reserved blocksize code {bs_code}")
        if sr_code == 12:
            br.read_uint(8)
        elif sr_code in (13, 14):
            br.read_uint(16)
        bps = _SIZE_TABLE.get(size_code, info.bits_per_sample) \
            if size_code else info.bits_per_sample
        br.read_uint(8)  # CRC-8 (not verified)

        if ch_code < 8:
            nch = ch_code + 1
            subs = [
                _decode_subframe(br, blocksize, bps) for _ in range(nch)
            ]
        elif ch_code == 8:  # left/side
            left = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            subs = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _decode_subframe(br, blocksize, bps + 1)
            right = _decode_subframe(br, blocksize, bps)
            subs = [right + side, right]
        elif ch_code == 10:  # mid/side
            mid = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            mid2 = (mid << 1) | (side & 1)
            subs = [(mid2 + side) >> 1, (mid2 - side) >> 1]
        else:
            raise FlacFormatError(f"reserved channel assignment {ch_code}")

        br.align()
        br.read_uint(16)  # CRC-16 (not verified)

        for c, s in enumerate(subs):
            channels_out[c].append(s)
        total += blocksize
        if info.total_samples and total >= info.total_samples:
            break

    out = np.stack(
        [np.concatenate(chunks) for chunks in channels_out]
    ).astype(np.int32)
    if info.total_samples:
        out = out[:, : info.total_samples]
    return out, info.sample_rate, info.bits_per_sample


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Decode FLAC -> (float32 [channels, samples] in [-1, 1], rate) with
    the same scaling convention as the WAV reader (x / 2^(bits-1))."""
    with open(path, "rb") as f:
        data = f.read()
    samples, rate, bits = decode_flac_bytes(data)
    return samples.astype(np.float32) / float(1 << (bits - 1)), rate
