"""JPEG decoding in numpy and the standard library, pixel for pixel what
libjpeg-turbo gives Pillow (and so imageio.v2.imread).

The JAX package reads an LLFF capture's JPGs through imageio / Pillow
(cfnerf_tpu/data/llff.py:36-40, 43-78); the port must also read them where
no image library is installed.  Supported, as libjpeg-turbo decodes them
with its defaults (JDCT_ISLOW, fancy upsampling, no block smoothing
needed):

  * frames: SOF0 (baseline), SOF1 (extended sequential, 8-bit), SOF2
    (progressive); 8- and 16-bit quantization tables (DQT), Huffman tables
    (DHT), restart intervals (DRI + RST0-7), byte stuffing and fill bytes;
    APPn / COM segments skipped, bytes after EOI ignored;
  * scans: interleaved and non-interleaved; progressive DC first / refine
    and AC first / refine (EOBRUN, correction bits), restarts resetting the
    DC predictors and EOBRUN;
  * pixels: dequantization and jpeg_idct_islow (jidctint.c's CONST_BITS
    13, PASS1_BITS 2, computed as libjpeg-turbo's x86 SIMD code computes it,
    which differs from the C code only for coefficients past 16 bits:
    _idct_islow), jdsample.c's fancy upsampling (h2v1 for 4:2:2, h2v2 for
    4:2:0, h1v2 for 4:4:0; plain replication where the chroma plane is at
    most 2 samples wide, as libjpeg-turbo does), the edge rows the main
    controller supplies, jdcolor.c's fixed-point YCbCr -> RGB (SCALEBITS
    16); an Adobe APP14 marker with transform 0 (and no JFIF marker) means
    RGB, taken as is.

A grayscale file decodes to uint8 (H, W), a colour file to (H, W, 3).  EXIF
orientation is not applied (Pillow's open does not apply it either).
Arithmetic coding, lossless and hierarchical frames, 12-bit samples, four
components (CMYK / YCCK), other sampling factors, progressive files whose
scans leave coefficient bits unsent (libjpeg would smooth the blocks) and
truncated or corrupt streams raise ValueError naming the file.

Entropy decoding is sequential: a Python loop over blocks with the bit
buffer in a Python int and, for each Huffman table, 2^16-entry lists indexed
by the next 16 bits (code length and symbol; for a sequential scan also the
code and its magnitude bits together where they fit in 16 bits).  Everything
after it is numpy over all blocks at once.
"""
from __future__ import annotations

import functools
import os
import re
import struct

import numpy as np

SOI, EOI, SOS, DHT, DQT, DRI = 0xD8, 0xD9, 0xDA, 0xC4, 0xDB, 0xDD
SOF_SEQUENTIAL = (0xC0, 0xC1)
SOF_PROGRESSIVE = 0xC2
_UNSUPPORTED_SOF = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
    0xC7: "hierarchical lossless (SOF7)", 0xC9: "arithmetic coding (SOF9)",
    0xCA: "arithmetic coding (SOF10)", 0xCB: "arithmetic lossless (SOF11)",
    0xCD: "arithmetic hierarchical (SOF13)", 0xCE: "arithmetic hierarchical (SOF14)",
    0xCF: "arithmetic hierarchical lossless (SOF15)", 0xCC: "arithmetic coding (DAC)",
    0xDE: "hierarchical (DHP)", 0xDC: "a DNL marker",
}
# the ratio of the largest sampling factors to a component's own (h, v):
# libjpeg-turbo's fullsize, h2v1, h1v2 and h2v2 upsamplers
_RATIOS = ((1, 1), (2, 1), (1, 2), (2, 2))


def _zigzag() -> np.ndarray:
    """jpeg_natural_order: zigzag index k -> natural index 8 * row + col."""
    cells = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1], rc[0] if (rc[0] + rc[1]) % 2 else -rc[0]))
    return np.array([8 * r + c for r, c in cells])


NATURAL = _zigzag()
_MASK = [(1 << n) - 1 for n in range(64)]


class _Bad(Exception):
    """A stream this decoder refuses; imread_jpeg names the file."""


# ---------------------------------------------------------------------- #
# headers
# ---------------------------------------------------------------------- #


class _Component:
    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None  # latched at the component's first scan, as libjpeg does


class _Frame:
    def __init__(self, marker, body):
        if marker in _UNSUPPORTED_SOF:
            raise _Bad(f"{_UNSUPPORTED_SOF[marker]} is not supported")
        if len(body) < 6:
            raise _Bad("SOF segment too short")
        precision, H, W, nf = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            raise _Bad(f"{precision}-bit samples are not supported (8-bit only)")
        if nf == 4:
            raise _Bad("four components (CMYK / YCCK) are not supported")
        if nf not in (1, 3):
            raise _Bad(f"{nf} components are not supported (1 or 3)")
        if H == 0 or W == 0:
            raise _Bad(f"frame of {W}x{H} (a DNL-defined height is not supported)")
        if len(body) < 6 + 3 * nf:
            raise _Bad("SOF segment too short")
        self.progressive = marker == SOF_PROGRESSIVE
        self.H, self.W = H, W
        self.comps = []
        for i in range(nf):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise _Bad(f"component {cid}: sampling {h}x{v}, table {tq}")
            self.comps.append(_Component(cid, h, v, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        for c in self.comps:
            ratio = (self.hmax // c.h, self.vmax // c.v)
            if (self.hmax % c.h or self.vmax % c.v or ratio not in _RATIOS) and nf > 1:
                raise _Bad("sampling factors " + ", ".join(
                    f"{d.h}x{d.v}" for d in self.comps) + " are not supported "
                    "(4:4:4, 4:2:2, 4:2:0 or 4:4:0)")
        self.mcux = -(-W // (8 * self.hmax))
        self.mcuy = -(-H // (8 * self.vmax))
        offset = 0
        for c in self.comps:
            # the plane's real size (libjpeg's downsampled_width / height)
            c.dw = -(-W * c.h // self.hmax)
            c.dh = -(-H * c.v // self.vmax)
            # coefficient storage padded to whole MCUs
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.offset = offset
            offset += c.bw * c.bh * 64
            # progressive bookkeeping: the successive-approximation bit each
            # coefficient is known down to (-1: never sent)
            c.coef_bits = [-1] * 64
        self.n_coefs = offset

    @property
    def shape(self):
        return (self.H, self.W) if len(self.comps) == 1 else (self.H, self.W, 3)


def _next_segment(data: bytes, pos: int):
    """(marker, body, position after it) of the marker segment at pos.
    Fill bytes (0xFF runs) before a marker are skipped; EOI has no body."""
    if pos >= len(data) or data[pos] != 0xFF:
        if pos >= len(data):
            raise _Bad("truncated JPEG stream (ends before EOI)")
        raise _Bad(f"expected a marker at byte {pos}, found 0x{data[pos]:02x}")
    while pos < len(data) and data[pos] == 0xFF:
        pos += 1
    if pos >= len(data):
        raise _Bad("truncated JPEG stream (ends before EOI)")
    marker = data[pos]
    pos += 1
    if marker == EOI:
        return marker, b"", pos
    if marker == SOI or 0xD0 <= marker <= 0xD7 or marker in (0x00, 0x01):
        raise _Bad(f"unexpected marker 0xff{marker:02x} at byte {pos - 2}")
    if pos + 2 > len(data):
        raise _Bad("truncated JPEG stream (in a marker segment)")
    (length,) = struct.unpack(">H", data[pos:pos + 2])
    if length < 2 or pos + length > len(data):
        raise _Bad(f"truncated or corrupt segment 0xff{marker:02x} at byte {pos - 2}")
    return marker, data[pos + 2:pos + length], pos + length


def _dqt(body, qtables):
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        n = 128 if pq else 64
        if pq > 1 or tq > 3 or pos + 1 + n > len(body):
            raise _Bad("corrupt DQT segment")
        zz = np.frombuffer(body[pos + 1:pos + 1 + n], ">u2" if pq else np.uint8)
        table = np.zeros(64, np.int64)
        table[NATURAL] = zz
        qtables[tq] = table
        pos += 1 + n


def _dht(body, htables):
    pos = 0
    while pos < len(body):
        if pos + 17 > len(body):
            raise _Bad("corrupt DHT segment")
        tc, th = body[pos] >> 4, body[pos] & 15
        counts = tuple(body[pos + 1:pos + 17])
        n = sum(counts)
        if tc > 1 or th > 3 or n > 256 or pos + 17 + n > len(body):
            raise _Bad("corrupt DHT segment")
        htables[tc, th] = (counts, bytes(body[pos + 17:pos + 17 + n]))
        pos += 17 + n


# ---------------------------------------------------------------------- #
# Huffman lookup tables
# ---------------------------------------------------------------------- #


@functools.lru_cache(maxsize=64)
def _lookup(counts: tuple, symbols: bytes):
    """(code length, symbol) of the code that the next 16 bits start with,
    for every 16-bit value: two numpy arrays of 2^16 (length 0: no code)."""
    hl = np.zeros(1 << 16, np.int64)
    hs = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for L in range(1, 17):
        for _ in range(counts[L - 1]):
            if code >= 1 << L:
                raise _Bad("corrupt Huffman table (too many codes)")
            lo, hi = code << (16 - L), (code + 1) << (16 - L)
            hl[lo:hi] = L
            hs[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return hl, hs


def _extend(v, s):
    """HUFF_EXTEND over arrays: s magnitude bits v as a signed value."""
    half = np.left_shift(1, np.maximum(s - 1, 0))
    return np.where(s == 0, 0, np.where(v < half, v - (np.left_shift(1, s) - 1), v))


@functools.lru_cache(maxsize=64)
def _dc_table(counts: tuple, symbols: bytes):
    """For the DC decoder: (fast length, fast difference, code length,
    symbol) lists.  Fast entries hold a code and its magnitude bits read
    together; 0 where they need more than 16 bits."""
    if any(s > 15 for s in symbols):
        raise _Bad("corrupt DC Huffman table (a symbol above 15)")
    hl, hs = _lookup(counts, symbols)
    p = np.arange(1 << 16, dtype=np.int64)
    total = hl + hs
    fits = (hl > 0) & (total <= 16)
    bits = (p >> np.clip(16 - total, 0, 16)) & ((np.left_shift(1, hs)) - 1)
    fast_len = np.where(fits, total, 0)
    fast_val = np.where(fits, _extend(bits, hs), 0)
    return fast_len.tolist(), fast_val.tolist(), hl.tolist(), hs.tolist()


EOB_RUN = 64  # a fast AC entry's run for an end of block: k passes 63


@functools.lru_cache(maxsize=64)
def _ac_table(counts: tuple, symbols: bytes):
    """For the sequential AC decoder: (fast length, fast run, fast value,
    code length, symbol) lists.  A fast entry holds a code and its magnitude
    bits together; an end of block has run EOB_RUN, a ZRL run 15 and value
    0."""
    hl, hs = _lookup(counts, symbols)
    p = np.arange(1 << 16, dtype=np.int64)
    r, s = hs >> 4, hs & 15
    total = hl + s
    fits = (hl > 0) & (total <= 16)
    bits = (p >> np.clip(16 - total, 0, 16)) & ((np.left_shift(1, s)) - 1)
    fast_len = np.where(fits, total, 0)
    fast_val = np.where(fits, _extend(bits, s), 0)
    # s == 0: ZRL (r == 15) skips 16 zeros; anything else ends the block
    fast_run = np.where((s == 0) & (r != 15), EOB_RUN, r)
    return fast_len.tolist(), fast_run.tolist(), fast_val.tolist(), hl.tolist(), hs.tolist()


@functools.lru_cache(maxsize=64)
def _plain_table(counts: tuple, symbols: bytes):
    hl, hs = _lookup(counts, symbols)
    return hl.tolist(), hs.tolist()


# ---------------------------------------------------------------------- #
# entropy-coded segments
# ---------------------------------------------------------------------- #

_MARKER = re.compile(rb"\xff+[^\x00\xff]")


def _scan_data(data: bytes, pos: int):
    """The entropy-coded data from `pos`: a list of restart intervals, each
    (32-bit words of its unstuffed bytes, padded with zeros; its bit
    count), and the position of the marker that ends the scan."""
    intervals = []
    start = pos
    while True:
        m = _MARKER.search(data, pos)
        if m is None:
            raise _Bad("truncated JPEG stream (a scan without an end)")
        seg = data[start:m.start()].replace(b"\xff\x00", b"\xff")
        nbits = 8 * len(seg)
        seg += bytes(8 + (-len(seg)) % 4)
        intervals.append((np.frombuffer(seg, ">u4").tolist(), nbits))
        marker = data[m.end() - 1]
        if not 0xD0 <= marker <= 0xD7:
            return intervals, m.end() - 2
        start = pos = m.end()


def _check_consumed(wi, nbits, total):
    """Refuse a restart interval whose decoding ran past its bytes (into
    the zero padding)."""
    if 32 * wi - nbits > total:
        raise _Bad("corrupt or truncated entropy-coded data")


def _scan_blocks(frame, comps, restart):
    """The blocks of one scan in decoding order, split into restart
    intervals: a list of lists of (coefficient base, slot in the scan)."""
    if len(comps) == 1:
        c = comps[0]
        bx, by = -(-c.dw // 8), -(-c.dh // 8)  # a non-interleaved scan: real blocks only
        rows, cols = np.divmod(np.arange(bx * by), bx)
        bases = c.offset + (rows * c.bw + cols) * 64
        slots = np.zeros_like(bases)
        per_mcu = 1
    else:
        mcus = np.arange(frame.mcux * frame.mcuy)
        my, mx = np.divmod(mcus, frame.mcux)
        cols_b, slot_b = [], []
        for slot, c in enumerate(comps):
            for v in range(c.v):
                for h in range(c.h):
                    cols_b.append(c.offset + ((my * c.v + v) * c.bw + mx * c.h + h) * 64)
                    slot_b.append(np.full_like(mcus, slot))
        bases = np.stack(cols_b, 1).reshape(-1)
        slots = np.stack(slot_b, 1).reshape(-1)
        per_mcu = len(cols_b)
    pairs = list(zip(bases.tolist(), slots.tolist()))
    if not restart:
        return [pairs]
    step = restart * per_mcu
    return [pairs[i:i + step] for i in range(0, len(pairs), step)]


# ---------------------------------------------------------------------- #
# scans
# ---------------------------------------------------------------------- #


def _sequential(intervals, blocks, tabs, coef):
    """Baseline / extended sequential: a DC difference and up to 63 AC
    coefficients a block, in zigzag order, into coef."""
    MASK = _MASK
    for (words, total), todo in zip(intervals, blocks):
        buf = nbits = wi = 0
        pred = [0] * len(tabs)
        for base, slot in todo:
            dlen, dval, dhl, dhs, alen, arun, aval, ahl, ahs = tabs[slot]
            if nbits < 16:
                buf = ((buf & MASK[nbits]) << 32) | words[wi]
                wi += 1
                nbits += 32
            p = (buf >> (nbits - 16)) & 0xFFFF
            n = dlen[p]
            if n:
                nbits -= n
                dc = pred[slot] + dval[p]
            else:
                n = dhl[p]
                if not n:
                    raise _Bad("corrupt entropy-coded data (no such DC code)")
                nbits -= n
                s = dhs[p]
                if nbits < s:
                    buf = ((buf & MASK[nbits]) << 32) | words[wi]
                    wi += 1
                    nbits += 32
                v = (buf >> (nbits - s)) & MASK[s]
                nbits -= s
                if v <= MASK[s - 1]:
                    v -= MASK[s]
                dc = pred[slot] + v
            pred[slot] = dc
            coef[base] = dc
            k = 1
            while k < 64:
                if nbits < 16:
                    buf = ((buf & MASK[nbits]) << 32) | words[wi]
                    wi += 1
                    nbits += 32
                p = (buf >> (nbits - 16)) & 0xFFFF
                n = alen[p]
                if n:
                    nbits -= n
                    k += arun[p]
                    if k > 63:
                        break
                    coef[base + k] = aval[p]
                    k += 1
                    continue
                n = ahl[p]
                if not n:
                    raise _Bad("corrupt entropy-coded data (no such AC code)")
                nbits -= n
                sym = ahs[p]
                s = sym & 15
                if nbits < s:
                    buf = ((buf & MASK[nbits]) << 32) | words[wi]
                    wi += 1
                    nbits += 32
                v = (buf >> (nbits - s)) & MASK[s]
                nbits -= s
                if v <= MASK[s - 1]:
                    v -= MASK[s]
                k += sym >> 4
                coef[base + min(k, 63)] = v  # jpeg_natural_order's extra entries: 63
                k += 1
        _check_consumed(wi, nbits, total)


def _dc_first(intervals, blocks, tabs, coef, al):
    """Progressive DC first scan: the DC difference, scaled by 2^Al."""
    MASK = _MASK
    scale = 1 << al
    for (words, total), todo in zip(intervals, blocks):
        buf = nbits = wi = 0
        pred = [0] * len(tabs)
        for base, slot in todo:
            hl, hs = tabs[slot]
            if nbits < 16:
                buf = ((buf & MASK[nbits]) << 32) | words[wi]
                wi += 1
                nbits += 32
            p = (buf >> (nbits - 16)) & 0xFFFF
            n = hl[p]
            if not n:
                raise _Bad("corrupt entropy-coded data (no such DC code)")
            nbits -= n
            s = hs[p]
            if s:
                if nbits < s:
                    buf = ((buf & MASK[nbits]) << 32) | words[wi]
                    wi += 1
                    nbits += 32
                v = (buf >> (nbits - s)) & MASK[s]
                nbits -= s
                if v <= MASK[s - 1]:
                    v -= MASK[s]
                pred[slot] += v
            coef[base] = pred[slot] * scale
        _check_consumed(wi, nbits, total)


def _dc_refine(intervals, blocks, coef, al):
    """Progressive DC refinement: one bit a block."""
    p1 = 1 << al
    for (words, total), todo in zip(intervals, blocks):
        buf = nbits = wi = 0
        for base, _ in todo:
            if not nbits:
                buf, wi, nbits = words[wi], wi + 1, 32
            nbits -= 1
            if (buf >> nbits) & 1:
                coef[base] |= p1
        _check_consumed(wi, nbits, total)


def _ac_first(intervals, blocks, hl, hs, coef, ss, se, al):
    """Progressive AC first scan of one component: band Ss..Se, values
    scaled by 2^Al, runs of empty bands (EOBRUN)."""
    MASK = _MASK
    scale = 1 << al
    for (words, total), todo in zip(intervals, blocks):
        buf = nbits = wi = 0
        eobrun = 0
        for base, _ in todo:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                if nbits < 16:
                    buf = ((buf & MASK[nbits]) << 32) | words[wi]
                    wi += 1
                    nbits += 32
                p = (buf >> (nbits - 16)) & 0xFFFF
                n = hl[p]
                if not n:
                    raise _Bad("corrupt entropy-coded data (no such AC code)")
                nbits -= n
                sym = hs[p]
                r, s = sym >> 4, sym & 15
                if s or r != 15:
                    n = s or r  # the value's bits, or the EOBRUN's
                    if nbits < n:
                        buf = ((buf & MASK[nbits]) << 32) | words[wi]
                        wi += 1
                        nbits += 32
                    v = (buf >> (nbits - n)) & MASK[n]
                    nbits -= n
                if s:
                    if v <= MASK[s - 1]:
                        v -= MASK[s]
                    k += r
                    coef[base + (k if k < 64 else 63)] = v * scale
                elif r == 15:
                    k += 15
                else:
                    eobrun = (1 << r) + v - 1
                    break
                k += 1
        _check_consumed(wi, nbits, total)


def _ac_refine(intervals, blocks, hl, hs, coef, ss, se, al):
    """Progressive AC refinement of one component (jdphuff.c's
    decode_mcu_AC_refine): newly nonzero coefficients of +-2^Al, and a
    correction bit for each coefficient already nonzero that the band's
    runs pass over."""
    MASK = _MASK
    p1, m1 = 1 << al, -1 << al
    for (words, total), todo in zip(intervals, blocks):
        buf = nbits = wi = 0
        eobrun = 0
        for base, _ in todo:
            k = ss
            if not eobrun:
                while k <= se:
                    if nbits < 16:
                        buf = ((buf & MASK[nbits]) << 32) | words[wi]
                        wi += 1
                        nbits += 32
                    p = (buf >> (nbits - 16)) & 0xFFFF
                    n = hl[p]
                    if not n:
                        raise _Bad("corrupt entropy-coded data (no such AC code)")
                    nbits -= n
                    sym = hs[p]
                    r = sym >> 4
                    new = 0
                    if sym & 15:  # a newly nonzero coefficient: its sign bit
                        if not nbits:
                            buf, wi, nbits = words[wi], wi + 1, 32
                        nbits -= 1
                        new = p1 if (buf >> nbits) & 1 else m1
                    elif r != 15:  # EOBr: this band and the next runs
                        eobrun = 1 << r
                        if r:
                            if nbits < r:
                                buf = ((buf & MASK[nbits]) << 32) | words[wi]
                                wi += 1
                                nbits += 32
                            nbits -= r
                            eobrun += (buf >> nbits) & MASK[r]
                        break
                    # pass over nonzero coefficients (a correction bit each)
                    # and r zero ones, to the new coefficient's place
                    while k <= se:
                        at = base + k
                        c = coef[at]
                        if c:
                            if not nbits:
                                buf, wi, nbits = words[wi], wi + 1, 32
                            nbits -= 1
                            if (buf >> nbits) & 1 and not c & p1:
                                coef[at] = c + (p1 if c >= 0 else m1)
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if new:
                        coef[base + (k if k < 64 else 63)] = new
                    k += 1
            if eobrun:
                while k <= se:
                    at = base + k
                    c = coef[at]
                    if c:
                        if not nbits:
                            buf, wi, nbits = words[wi], wi + 1, 32
                        nbits -= 1
                        if (buf >> nbits) & 1 and not c & p1:
                            coef[at] = c + (p1 if c >= 0 else m1)
                    k += 1
                eobrun -= 1
        _check_consumed(wi, nbits, total)


def _scan(frame, body, data, pos, htables, qtables, restart, coef):
    """Decode one scan starting at data[pos]; returns the position of the
    marker after it."""
    if len(body) < 1 or len(body) < 1 + 2 * body[0] + 3:
        raise _Bad("corrupt SOS segment")
    ns = body[0]
    by_id = {c.cid: c for c in frame.comps}
    comps, sel = [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in by_id or by_id[cid] in comps:
            raise _Bad(f"scan names component {cid}, not in the frame once")
        comps.append(by_id[cid])
        sel.append((t >> 4, t & 15))
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if ns > 1 and sum(c.h * c.v for c in comps) > 10:  # D_MAX_BLOCKS_IN_MCU
        raise _Bad("too many blocks in an MCU")
    for c in comps:
        if c.qt is None:
            if c.tq not in qtables:
                raise _Bad(f"component {c.cid} uses undefined quantization table {c.tq}")
            c.qt = qtables[c.tq]

    def table(cls, th):
        if (cls, th) not in htables:
            raise _Bad(f"scan uses undefined Huffman table {'DC' if cls == 0 else 'AC'}{th}")
        return htables[cls, th]

    intervals, end = _scan_data(data, pos)
    blocks = _scan_blocks(frame, comps, restart)
    if len(intervals) != len(blocks):
        raise _Bad(f"corrupt entropy-coded data: {len(intervals)} restart intervals, "
                   f"{len(blocks)} expected")

    if not frame.progressive:
        if (ss, se, ah, al) != (0, 63, 0, 0):
            raise _Bad("sequential scan with a spectral selection")
        tabs = [_dc_table(*table(0, td)) + _ac_table(*table(1, ta)) for td, ta in sel]
        _sequential(intervals, blocks, tabs, coef)
        for c in comps:
            c.coef_bits = [0] * 64
        return end

    dc = ss == 0
    if (dc and se != 0) or (not dc and (ss > se or se > 63 or ns != 1)) \
            or (ah and al != ah - 1) or al > 13:
        raise _Bad(f"invalid progression parameters Ss={ss} Se={se} Ah={ah} Al={al}")
    for c in comps:
        c.coef_bits[ss:se + 1] = [al] * (se + 1 - ss)
    if dc and not ah:
        _dc_first(intervals, blocks, [_plain_table(*table(0, td)) for td, _ in sel], coef, al)
    elif dc:
        _dc_refine(intervals, blocks, coef, al)
    elif not ah:
        _ac_first(intervals, blocks, *_plain_table(*table(1, sel[0][1])), coef, ss, se, al)
    else:
        _ac_refine(intervals, blocks, *_plain_table(*table(1, sel[0][1])), coef, ss, se, al)
    return end


# ---------------------------------------------------------------------- #
# pixels
# ---------------------------------------------------------------------- #

CONST_BITS, PASS1_BITS = 13, 2
# jidctint.c's FIX() constants
F0298, F0390, F0541, F0765, F0899, F1175 = 2446, 3196, 4433, 6270, 7373, 9633
F1501, F1847, F1961, F2053, F2562, F3072 = 12299, 15137, 16069, 16819, 20995, 25172


def _idct_1d(x):
    """One pass of the islow IDCT over x[0..7] (int16 arrays): the eight
    int32 sums before their descale, in the SIMD order (the C code's
    products regrouped so that each is a pair of 16-bit products, pmaddwd),
    with its 16-bit sums in0 + in4, in0 - in4, in7 + in3 and in5 + in1."""
    i32 = np.int32
    x1, x2, x3, x5, x6, x7 = (x[k].astype(i32) for k in (1, 2, 3, 5, 6, 7))
    tmp3 = x2 * (F0541 + F0765) + x6 * F0541
    tmp2 = x2 * F0541 + x6 * (F0541 - F1847)
    tmp0 = (x[0] + x[4]).astype(i32) << CONST_BITS
    tmp1 = (x[0] - x[4]).astype(i32) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z3 = (x[7] + x[3]).astype(i32)
    z4 = (x[5] + x[1]).astype(i32)
    z3, z4 = z3 * (F1175 - F1961) + z4 * F1175, z3 * F1175 + z4 * (F1175 - F0390)
    t0 = x7 * (F0298 - F0899) + x1 * -F0899 + z3
    t1 = x5 * (F2053 - F2562) + x3 * -F2562 + z4
    t2 = x5 * -F2562 + x3 * (F3072 - F2562) + z3
    t3 = x7 * -F0899 + x1 * (F1501 - F0899) + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _idct_islow(coefs, qt):
    """jpeg_idct_islow of (n, 64) zigzag-ordered int16 coefficients with the
    natural-order quantization table qt: (n, 8, 8) uint8 samples.

    Computed as libjpeg-turbo's x86 SIMD version computes it (the one
    Pillow's libjpeg-turbo runs): wherever the dequantized coefficients and
    the sums fit 16 bits this is jidctint.c's arithmetic exactly (CONST_BITS
    13, PASS1_BITS 2).  Beyond, as there, the dequantization and the 16-bit
    sums wrap, the int32 sums wrap, the workspace saturates to int16, a
    block whose rows 1-7 are all zero takes the DC shortcut in 16 bits, and
    the output saturates to [-128, 127] before the +128 (where jidctint.c
    would index its range-limit table by x & 1023)."""
    nat = np.zeros(coefs.shape, np.int16)
    nat[:, NATURAL] = coefs
    z = (nat * qt.astype(np.int16)).reshape(-1, 8, 8)  # pmullw: the low 16 bits
    sums = _idct_1d([z[:, k, :] for k in range(8)])  # pass 1: the columns
    half = 1 << (CONST_BITS - PASS1_BITS - 1)
    ws = np.stack([np.clip((s + half) >> (CONST_BITS - PASS1_BITS), -32768, 32767)
                   for s in sums], 1).astype(np.int16)
    dc_only = ~nat.reshape(-1, 8, 8)[:, 1:, :].any((1, 2))
    ws[dc_only] = (z[dc_only, :1, :] << PASS1_BITS)
    sums = _idct_1d([ws[:, :, k] for k in range(8)])  # pass 2: the rows
    shift = CONST_BITS + PASS1_BITS + 3
    half = 1 << (shift - 1)
    return np.stack([(np.clip((s + half) >> shift, -128, 127) + 128).astype(np.uint8)
                     for s in sums], 2)


def _plane(c, coef):
    """The component's samples, cropped to its real size (dh, dw)."""
    n = c.bw * c.bh
    blocks = coef[c.offset:c.offset + 64 * n].reshape(n, 64)
    out = np.empty((n, 8, 8), np.uint8)
    step = 8192  # blocks an IDCT call, to bound the int64 temporaries
    for i in range(0, n, step):
        out[i:i + step] = _idct_islow(blocks[i:i + step], c.qt)
    plane = out.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(8 * c.bh, 8 * c.bw)
    return plane[:c.dh, :c.dw]


def _edge(a, axis, step):
    """a shifted by one along axis (step -1: the previous sample, +1: the
    next), the edge sample repeated."""
    n = a.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(a, idx, axis=axis)


def _interleave(even, odd, axis):
    out = np.stack([even, odd], axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(plane, ratio):
    """jdsample.c for one component: (dh, dw) uint8 -> int32 at the frame's
    sampling (before the crop to the image)."""
    x = plane.astype(np.int32)
    hr, vr = ratio
    dw = x.shape[1]
    if (hr, vr) == (1, 1):
        return x
    if (hr, vr) == (1, 2):  # h1v2_fancy_upsample
        t = 3 * x
        return _interleave((t + _edge(x, 0, -1) + 1) >> 2, (t + _edge(x, 0, 1) + 2) >> 2, 0)
    if dw <= 2:  # h2v1_upsample / h2v2_upsample: replication
        return np.repeat(np.repeat(x, hr, 1), vr, 0)
    if vr == 1:  # h2v1_fancy_upsample
        t = 3 * x
        return _interleave((t + _edge(x, 1, -1) + 1) >> 2, (t + _edge(x, 1, 1) + 2) >> 2, 1)
    # h2v2_fancy_upsample: column sums of 3 x nearer + farther row, then
    # 3 x nearer + farther column sum, biases 8 and 7
    t = 3 * x
    cols = _interleave(t + _edge(x, 0, -1), t + _edge(x, 0, 1), 0)
    t = 3 * cols
    return _interleave((t + _edge(cols, 1, -1) + 8) >> 4, (t + _edge(cols, 1, 1) + 7) >> 4, 1)


def _fix(x):
    return int(x * (1 << 16) + 0.5)


_CENTERED = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _CENTERED + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _CENTERED + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _CENTERED
_CB_G = -_fix(0.34414) * _CENTERED + (1 << 15)


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert, clamped by the range-limit table."""
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _color_space(frame, jfif, adobe_transform):
    """jdapimin.c's guess for three components: 'ycc' or 'rgb'."""
    if jfif:
        return "ycc"
    if adobe_transform is not None:
        return "rgb" if adobe_transform == 0 else "ycc"
    if [c.cid for c in frame.comps] == [82, 71, 66]:  # 'R', 'G', 'B'
        return "rgb"
    return "ycc"


def _smoothing_wanted(frame):
    """jdcoefct.c's smoothing_ok after the last scan: libjpeg smooths the
    blocks of a progressive image whose first AC coefficients are not
    known to their last bit."""
    if not frame.progressive or any(c.coef_bits[0] < 0 for c in frame.comps):
        return False
    if any(c.qt is None or not np.all(c.qt[NATURAL[:10]]) for c in frame.comps):
        return False
    return any(b != 0 for c in frame.comps for b in c.coef_bits[1:10])


def _decode(data: bytes) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise _Bad("not a JPEG file (no SOI marker)")
    qtables, htables = {}, {}
    frame, restart, jfif, adobe = None, 0, False, None
    pos = 2
    while True:
        marker, body, pos = _next_segment(data, pos)
        if marker == EOI:
            break
        if marker in SOF_SEQUENTIAL or marker == SOF_PROGRESSIVE or marker in _UNSUPPORTED_SOF:
            if frame is not None:
                raise _Bad("a second frame header")
            frame = _Frame(marker, body)
            coef = [0] * frame.n_coefs
        elif marker == DQT:
            _dqt(body, qtables)
        elif marker == DHT:
            _dht(body, htables)
        elif marker == DRI:
            if len(body) < 2:
                raise _Bad("corrupt DRI segment")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
            adobe = body[11]
        elif marker == SOS:
            if frame is None:
                raise _Bad("a scan before the frame header")
            pos = _scan(frame, body, data, pos, htables, qtables, restart, coef)
        elif not (0xE0 <= marker <= 0xEF or marker == 0xFE):
            raise _Bad(f"unexpected marker 0xff{marker:02x}")
    if frame is None:
        raise _Bad("no frame header before EOI")
    if any(c.qt is None for c in frame.comps):
        raise _Bad("a component that no scan covers")
    if _smoothing_wanted(frame):
        raise _Bad("progressive scans leave coefficient bits unsent (libjpeg would smooth "
                   "the blocks; not supported)")
    coefs = np.asarray(coef, np.int64).astype(np.int16)  # JCOEF
    planes = []
    for c in frame.comps:
        up = _upsample(_plane(c, coefs), (frame.hmax // c.h, frame.vmax // c.v))
        planes.append(up[:frame.H, :frame.W])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if _color_space(frame, jfif, adobe) == "rgb":
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*(p.astype(np.int64) for p in planes))


def decode(data: bytes, name="JPEG data") -> np.ndarray:
    """Decode a JPEG stream held in memory as imread_jpeg decodes a file;
    a refusal raises ValueError starting with `name`."""
    try:
        return _decode(data)
    except _Bad as e:
        raise ValueError(f"{name}: {e}") from None
    except (IndexError, struct.error) as e:
        raise ValueError(f"{name}: corrupt or truncated JPEG stream ({e})") from None


def imread_jpeg(path) -> np.ndarray:
    """Decode a JPEG file into the array imageio.v2.imread returns for it:
    uint8 (H, W) for a grayscale file, (H, W, 3) for a colour one."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, os.fspath(path))


def jpeg_shape(path) -> tuple:
    """The shape imread_jpeg(path) returns, from the marker segments up to
    the frame header (the entropy-coded data is not decoded); refuses what
    imread_jpeg refuses in the frame header."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data[:2] != b"\xff\xd8":
            raise _Bad("not a JPEG file (no SOI marker)")
        pos = 2
        while True:
            marker, body, pos = _next_segment(data, pos)
            if marker in SOF_SEQUENTIAL or marker == SOF_PROGRESSIVE \
                    or marker in _UNSUPPORTED_SOF:
                return _Frame(marker, body).shape
            if marker in (SOS, EOI):
                raise _Bad(f"marker 0xff{marker:02x} before any frame header")
    except _Bad as e:
        raise ValueError(f"{os.fspath(path)}: {e}") from None
