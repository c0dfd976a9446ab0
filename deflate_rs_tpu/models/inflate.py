"""Host-side DEFLATE decoder (validation oracle).

The reference has no decoder of its own — its tests delegate to miniz_oxide
(test_utils.rs:23-72).  We keep stdlib ``zlib`` as the *independent* oracle and
provide this spec-complete inflate as the framework's own second oracle (build
plan SURVEY.md §7.2), also used to cross-check header encodings field by field.

Pure Python; clarity over speed — this is a test oracle, not the data path.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0

    def read(self, n: int) -> int:
        """Read n bits LSB-first."""
        out = 0
        for k in range(n):
            byte = self.data[self.bitpos >> 3]
            bit = (byte >> (self.bitpos & 7)) & 1
            out |= bit << k
            self.bitpos += 1
        return out

    def align(self):
        self.bitpos = (self.bitpos + 7) & ~7


class _Decoder:
    """Canonical Huffman decoder: walk code lengths MSB-first."""

    def __init__(self, lengths):
        lengths = list(lengths)
        max_len = max(lengths) if any(lengths) else 0
        count = [0] * (max_len + 1)
        for l in lengths:
            if l:
                count[l] += 1
        first_code = [0] * (max_len + 2)
        code = 0
        for l in range(1, max_len + 1):
            code = (code + count[l - 1]) << 1
            first_code[l] = code
        # symbols sorted by (length, symbol)
        offset = [0] * (max_len + 1)
        acc = 0
        for l in range(1, max_len + 1):
            offset[l] = acc
            acc += count[l]
        syms = [0] * acc
        idx = offset[:]
        for s, l in enumerate(lengths):
            if l:
                syms[idx[l]] = s
                idx[l] += 1
        self.count, self.first_code, self.offset, self.syms = count, first_code, offset, syms
        self.max_len = max_len

    def decode(self, br: BitReader) -> int:
        code = 0
        for l in range(1, self.max_len + 1):
            code = (code << 1) | br.read(1)
            if self.count[l] and code - self.first_code[l] < self.count[l]:
                return self.syms[self.offset[l] + code - self.first_code[l]]
        raise ValueError("invalid Huffman code in stream")


def inflate(data: bytes, tokens: list | None = None) -> bytes:
    """Decode a raw DEFLATE stream.

    ``tokens``, if given, receives the stream's tokens in order:
    ``("lit", byte)`` for each literal and each stored byte,
    ``("m", length, distance)`` for each match.
    """
    br = BitReader(data)
    out = bytearray()
    while True:
        bfinal = br.read(1)
        btype = br.read(2)
        if btype == C.BTYPE_STORED:
            br.align()
            ln = br.read(16)
            nlen = br.read(16)
            if ln != (~nlen & 0xFFFF):
                raise ValueError("stored block LEN/NLEN mismatch")
            start = br.bitpos >> 3
            out += br.data[start : start + ln]
            if tokens is not None:
                tokens.extend(("lit", b) for b in br.data[start : start + ln])
            br.bitpos += 8 * ln
        elif btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC):
            if btype == C.BTYPE_FIXED:
                lit_dec = _Decoder(C.FIXED_LITLEN_LENGTHS.tolist())
                dist_dec = _Decoder(C.FIXED_DIST_LENGTHS.tolist())
            else:
                hlit = br.read(5) + 257
                hdist = br.read(5) + 1
                hclen = br.read(4) + 4
                clen_lengths = [0] * 19
                for i in range(hclen):
                    clen_lengths[int(C.CLEN_ORDER[i])] = br.read(3)
                clen_dec = _Decoder(clen_lengths)
                lengths = []
                while len(lengths) < hlit + hdist:
                    sym = clen_dec.decode(br)
                    if sym < 16:
                        lengths.append(sym)
                    elif sym == 16:
                        if not lengths:
                            raise ValueError("repeat with no previous length")
                        lengths += [lengths[-1]] * (3 + br.read(2))
                    elif sym == 17:
                        lengths += [0] * (3 + br.read(3))
                    else:
                        lengths += [0] * (11 + br.read(7))
                if len(lengths) != hlit + hdist:
                    raise ValueError("code length overrun")
                lit_dec = _Decoder(lengths[:hlit])
                dist_dec = _Decoder(lengths[hlit:])
            while True:
                sym = lit_dec.decode(br)
                if sym < 256:
                    out.append(sym)
                    if tokens is not None:
                        tokens.append(("lit", sym))
                elif sym == 256:
                    break
                else:
                    ci = sym - 257
                    if ci >= 29:
                        raise ValueError("invalid length symbol")
                    length = int(C.LENGTH_BASE[ci]) + br.read(int(C.LENGTH_EXTRA_BITS[ci]))
                    dsym = dist_dec.decode(br)
                    if dsym >= 30:
                        raise ValueError("invalid distance symbol")
                    dist = int(C.DIST_BASE[dsym]) + br.read(int(C.DIST_EXTRA_BITS[dsym]))
                    if dist > len(out):
                        raise ValueError("distance beyond output")
                    if tokens is not None:
                        tokens.append(("m", length, dist))
                    for _ in range(length):
                        out.append(out[-dist])
        else:
            raise ValueError("invalid block type 3")
        if bfinal:
            break
    return bytes(out)


def inflate_zlib(data: bytes) -> bytes:
    """Decode a zlib stream, verifying header and Adler-32 trailer."""
    if len(data) < 6:
        raise ValueError("zlib stream too short")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != 8 or (cmf * 256 + flg) % 31 != 0:
        raise ValueError("bad zlib header")
    if flg & 0x20:
        # FDICT: the 4 bytes after the header are a dictionary id, not
        # DEFLATE data.  Preset dictionaries are out of scope (the encoder
        # never emits them) — reject cleanly instead of decoding garbage.
        raise ValueError("zlib preset dictionary (FDICT) not supported")
    raw = inflate(data[2:-4])
    adler = int.from_bytes(data[-4:], "big")
    a, b = 1, 0
    for byte in raw:
        a = (a + byte) % C.ADLER_MOD
        b = (b + a) % C.ADLER_MOD
    if ((b << 16) | a) != adler:
        raise ValueError("Adler-32 mismatch")
    return raw


def inflate_gzip(data: bytes) -> bytes:
    """Decode a gzip member, verifying CRC-32 and ISIZE."""
    import zlib as _z

    if data[:2] != b"\x1f\x8b" or data[2] != 8:
        raise ValueError("bad gzip header")
    flg = data[3]
    pos = 10
    if flg & 0x04:  # FEXTRA
        xlen = int.from_bytes(data[pos : pos + 2], "little")
        pos += 2 + xlen
    if flg & 0x08:  # FNAME
        pos = data.index(0, pos) + 1
    if flg & 0x10:  # FCOMMENT
        pos = data.index(0, pos) + 1
    if flg & 0x02:  # FHCRC
        pos += 2
    raw = inflate(data[pos:-8])
    crc = int.from_bytes(data[-8:-4], "little")
    isize = int.from_bytes(data[-4:], "little")
    if crc != _z.crc32(raw) or isize != len(raw) % (1 << 32):
        raise ValueError("gzip trailer mismatch")
    return raw
