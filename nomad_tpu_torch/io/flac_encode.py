"""Minimal FLAC encoder: valid streams for round-trip tests of the decoders
and for writing FLAC without external tools.

A copy of ``nomad_tpu.io.flac_encode``; the tests hold its bytes to the
original's. Encodes independent channels with a per-subframe choice of
CONSTANT, VERBATIM, FIXED(0-2) or LPC + rice (partition order 0), with
correct CRC-8/CRC-16 and UTF-8 frame numbers. Not tuned for compression.
"""

from __future__ import annotations

import struct

import numpy as np

from .flac import FIXED_COEFFS


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int):
        if n == 0:
            return
        value &= (1 << n) - 1
        self.acc = (self.acc << n) | value
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, n: int):
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    bits = n.bit_length()
    nbytes = 2
    while bits > 5 * nbytes + (7 - nbytes):
        nbytes += 1
    out.append(((0xFF << (8 - nbytes)) & 0xFF) | (n >> (6 * (nbytes - 1))))
    for i in range(nbytes - 2, -1, -1):
        out.append(0x80 | ((n >> (6 * i)) & 0x3F))
    return bytes(out)


def _rice_encode(bw: BitWriter, resid, param: int):
    for v in resid:
        v = int(v)
        u = (v << 1) if v >= 0 else ((-v) << 1) - 1  # zigzag
        q, r = u >> param, u & ((1 << param) - 1)
        bw.write_unary(q)
        if param:
            bw.write(r, param)


def _best_rice_param(resid) -> int:
    if len(resid) == 0:
        return 0
    mean = float(np.mean(np.abs(np.asarray(resid, np.float64)))) + 1.0
    p = max(0, int(np.log2(mean)))
    return min(p, 14)


def _encode_subframe(bw: BitWriter, x: np.ndarray, bps: int, mode: str):
    if mode == "constant":
        bw.write(0, 1)
        bw.write(0, 6)
        bw.write(0, 1)
        bw.write_signed(int(x[0]), bps)
        return
    if mode == "verbatim":
        bw.write(0, 1)
        bw.write(1, 6)
        bw.write(0, 1)
        for v in x:
            bw.write_signed(int(v), bps)
        return
    if mode.startswith("lpc"):
        # quantized-LPC subframe (order from mode, e.g. 'lpc2'); coeffs are
        # the fixed-predictor ones scaled by 2^shift — exercises the LPC
        # decode path with exact integer round-trip
        order = int(mode[3:])
        shift = 5
        qcoeffs = [c << shift for c in FIXED_COEFFS[order]]
        precision = 12
        bw.write(0, 1)
        bw.write(32 + order - 1, 6)
        bw.write(0, 1)
        for v in x[:order]:
            bw.write_signed(int(v), bps)
        bw.write(precision - 1, 4)
        bw.write_signed(shift, 5)
        for c in qcoeffs:
            bw.write_signed(c, precision)
        xs = x.astype(np.int64)
        resid = []
        for i in range(order, len(xs)):
            acc = sum(qcoeffs[j] * int(xs[i - 1 - j]) for j in range(order))
            resid.append(int(xs[i]) - (acc >> shift))
        param = _best_rice_param(resid)
        bw.write(0, 2)
        bw.write(0, 4)
        bw.write(param, 4)
        _rice_encode(bw, resid, param)
        return
    order = int(mode[-1])  # 'fixed0'..'fixed2'
    coeffs = FIXED_COEFFS[order]
    bw.write(0, 1)
    bw.write(8 + order, 6)
    bw.write(0, 1)
    for v in x[:order]:
        bw.write_signed(int(v), bps)
    xs = x.astype(np.int64)
    resid = []
    for i in range(order, len(xs)):
        pred = sum(c * int(xs[i - 1 - j]) for j, c in enumerate(coeffs))
        resid.append(int(xs[i]) - pred)
    param = _best_rice_param(resid)
    bw.write(0, 2)  # rice method
    bw.write(0, 4)  # partition order 0
    bw.write(param, 4)
    _rice_encode(bw, resid, param)


def encode_flac(
    samples: np.ndarray,
    sample_rate: int,
    bits: int = 16,
    block_size: int = 4096,
    subframe_mode: str = "fixed2",
) -> bytes:
    """samples: int [channels, n] or [n]; returns a FLAC byte stream."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[None, :]
    channels, n = x.shape
    x = x.astype(np.int64)

    out = bytearray(b"fLaC")
    si = BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bits - 1, 5)
    si.write(n, 36)
    for _ in range(16):
        si.write(0, 8)  # md5 unset
    body = si.bytes()
    out += bytes([0x80]) + struct.pack(">I", len(body))[1:] + body

    frame_idx = 0
    for start in range(0, n, block_size):
        blk = x[:, start : start + block_size]
        bs = blk.shape[1]

        hdr = BitWriter()
        hdr.write(0x3FFE, 14)
        hdr.write(0, 1)
        hdr.write(0, 1)  # fixed blocksize strategy
        if bs == block_size and block_size == 4096:
            bs_code, bs_extra = 12, None
        else:
            bs_code, bs_extra = 7, bs - 1
        hdr.write(bs_code, 4)
        sr_code = {8000: 4, 16000: 5, 22050: 6, 24000: 7, 32000: 8,
                   44100: 9, 48000: 10}.get(sample_rate, 0)
        hdr.write(sr_code, 4)
        hdr.write(channels - 1, 4)  # independent channels
        size_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bits]
        hdr.write(size_code, 3)
        hdr.write(0, 1)
        for b in _utf8_number(frame_idx):
            hdr.write(b, 8)
        if bs_code == 7:
            hdr.write(bs_extra, 16)
        hdr.align()
        hbytes = hdr.bytes()
        hbytes += bytes([crc8(hbytes)])

        bw = BitWriter()
        for c in range(channels):
            ch = blk[c]
            mode = subframe_mode
            if np.all(ch == ch[0]):
                mode = "constant"
            elif (mode.startswith("fixed") or mode.startswith("lpc")) and bs <= int(
                mode[-1]
            ):
                mode = "verbatim"  # block shorter than the predictor order
            _encode_subframe(bw, ch, bits, mode)
        bw.align()
        frame = hbytes + bw.bytes()
        frame += struct.pack(">H", crc16(frame))
        out += frame
        frame_idx += 1
    return bytes(out)


def write_flac(path: str, wave: np.ndarray, sample_rate: int, bits: int = 16):
    """float32 [-1,1] [channels, n] or [n] -> FLAC file."""
    w = np.asarray(wave)
    scale = float(1 << (bits - 1))
    pcm = np.clip(np.round(w * scale), -scale, scale - 1).astype(np.int64)
    with open(path, "wb") as f:
        f.write(encode_flac(pcm, sample_rate, bits=bits))
