"""Test-only JPEG encoders for the forms that neither OpenCV nor PIL writes:
12-bit DCT files (SOF1 / SOF2), arithmetic-coded files (SOF9 sequential,
SOF10 progressive with spectral selection and successive approximation,
DAC), lossless files (SOF3, predictors 1-7, point transform) and 4-component
files (CMYK, YCCK) with or without an Adobe marker.

The encoders only have to write valid streams: the tests decode the same
bytes with ``cv2.imdecode`` and with the port and want equal arrays. The
arithmetic coder is ITU T.81 Annex D as libjpeg's ``jcarith.c`` writes it,
with the Qe table of T.81 Table D.2 (``ARITAB``).
"""

from __future__ import annotations

import struct

import numpy as np

NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
           12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
           35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
           58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

# T.81 Table D.2: Qe << 16 | NMPS << 8 | SWITCH << 7 | NLPS, 113 states and
# the fixed-probability state 113
ARITAB = [
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171]


def seeded_samples(seed, h, w, channels, precision=8):
    """Smooth noise and a gradient in ``precision`` bits, (h, w, channels)
    int64."""
    rng = np.random.default_rng(seed)
    top = (1 << precision) - 1
    noise = rng.integers(0, top + 1, (h + 2, w + 2, channels))
    box = sum(noise[dy:dy + h, dx:dx + w] for dy in range(3)
              for dx in range(3)) // 9
    grad = (np.arange(h)[:, None, None] * top // max(h, 1) +
            np.arange(w)[None, :, None] * top // max(w, 1)) // 2
    return np.clip(box // 2 + grad // 2, 0, top).astype(np.int64)


# ---- segments ---------------------------------------------------------------
def segment(marker, body=b''):
    return struct.pack('>BBH', 0xFF, marker, len(body) + 2) + body


def jfif():
    return segment(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00')


def adobe(transform):
    return segment(0xEE, b'Adobe\x00\x64\x00\x00\x00\x00' +
                   bytes([transform]))


def dqt(index, table):
    """A quantization table in natural order; 16-bit entries when any is
    over 255."""
    wide = max(table) > 255
    body = bytes([(1 if wide else 0) << 4 | index])
    for k in range(64):
        v = int(table[NATURAL[k]])
        body += struct.pack('>H', v) if wide else bytes([v])
    return segment(0xDB, body)


def flat_huffman(n_symbols):
    """Code counts (16 lengths) for symbols 0..n-1: one length for all where
    a count byte holds them, else 128 of 8 bits and the rest of 9; no code
    is all ones."""
    bits = [0] * 16
    if n_symbols > 255:
        bits[7], bits[8] = 128, n_symbols - 128
        return bits
    length = 1
    while (1 << length) <= n_symbols:
        length += 1
    bits[length - 1] = n_symbols
    return bits


def dht(cls, index, symbols):
    bits = flat_huffman(len(symbols))
    return segment(0xC4, bytes([cls << 4 | index] + bits + list(symbols)))


def huffman_codes(symbols):
    """symbol -> (code, length) of :func:`flat_huffman`'s canonical
    table."""
    bits = flat_huffman(len(symbols))
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def sof(marker, precision, h, w, comps):
    """comps: (id, h, v, tq)"""
    body = struct.pack('>BHHB', precision, h, w, len(comps))
    for cid, hs, vs, tq in comps:
        body += bytes([cid, hs << 4 | vs, tq])
    return segment(marker, body)


def sos(comps, ss, se, ah, al):
    """comps: (id, dc table, ac table)"""
    body = bytes([len(comps)])
    for cid, td, ta in comps:
        body += bytes([cid, td << 4 | ta])
    return segment(0xDA, body + bytes([ss, se, ah << 4 | al]))


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = self.acc << 1 | (value >> i) & 1
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        while self.n:
            self.put(1, 1)
        return bytes(self.out)


def category(v):
    return int(abs(int(v))).bit_length()


def magnitude_bits(v, s):
    return v if v >= 0 else v + (1 << s) - 1


# ---- the arithmetic coder (jcarith.c) ---------------------------------------
class ArithEncoder:
    def __init__(self, dc_l=0, dc_u=1, ac_k=5):
        self.dc_l, self.dc_u, self.ac_k = dc_l, dc_u, ac_k
        self.out = bytearray()
        self.fixed = [113, 0, 0, 0]
        self.start()

    def start(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def emit(self, b):
        self.out.append(b)

    def _flush_stacked(self, byte):
        if self.zc:
            self.out += b'\x00' * self.zc
            self.zc = 0
        self.emit(byte)

    def encode(self, st, i, val):
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        qe >>= 8
        nm = qe & 0xFF
        qe >>= 8
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_stacked(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self.emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_stacked(self.buffer)
                    if self.sc:
                        if self.zc:
                            self.out += b'\x00' * self.zc
                            self.zc = 0
                        self.out += b'\xff\x00' * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_stacked(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_stacked(self.buffer)
            if self.sc:
                if self.zc:
                    self.out += b'\x00' * self.zc
                    self.zc = 0
                self.out += b'\xff\x00' * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            if self.zc:
                self.out += b'\x00' * self.zc
                self.zc = 0
            b = (self.c >> 19) & 0xFF
            self.emit(b)
            if b == 0xFF:
                self.emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.emit(b)
                if b == 0xFF:
                    self.emit(0)

    def dc(self, stats, context, ci, v):
        """One DC difference; updates context[ci]."""
        i = context[ci]
        if v == 0:
            self.encode(stats, i, 0)
            context[ci] = 0
            return
        self.encode(stats, i, 1)
        if v > 0:
            self.encode(stats, i + 1, 0)
            i += 2
            context[ci] = 4
        else:
            v = -v
            self.encode(stats, i + 1, 1)
            i += 3
            context[ci] = 8
        m = self._dc_category(stats, i, v)
        if m < (1 << self.dc_l) >> 1:
            context[ci] = 0
        elif m > (1 << self.dc_u) >> 1:
            context[ci] += 8

    def _dc_category(self, stats, i, v):
        m = 0
        v -= 1
        st_i = i
        if v:
            self.encode(stats, st_i, 1)
            m = 1
            v2 = v
            st_i = 20
            while True:
                v2 >>= 1
                if not v2:
                    break
                self.encode(stats, st_i, 1)
                m <<= 1
                st_i += 1
        self.encode(stats, st_i, 0)
        cat = m
        st_i += 14
        while True:
            m >>= 1
            if not m:
                break
            self.encode(stats, st_i, 1 if m & v else 0)
        return cat

    def ac_value(self, stats, i, k, v):
        """A nonzero AC value's category and bits after its sign, from
        st = stats[i + 2]."""
        i += 2
        m = 0
        v -= 1
        if v:
            self.encode(stats, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                self.encode(stats, i, 1)
                m <<= 1
                i = 189 if k <= self.ac_k else 217
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    self.encode(stats, i, 1)
                    m <<= 1
                    i += 1
        self.encode(stats, i, 0)
        i += 14
        while True:
            m >>= 1
            if not m:
                break
            self.encode(stats, i, 1 if m & v else 0)


def _ac_first_arith(enc, stats, block, ss, se, al):
    def point(v):
        return -((-v) >> al) if v < 0 else v >> al
    ke = se
    while ke > 0 and point(block[NATURAL[ke]]) == 0:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(stats, i, 0)
        while True:
            v = point(block[NATURAL[k]])
            if v:
                enc.encode(stats, i + 1, 1)
                enc.encode(enc.fixed, 0, 1 if v < 0 else 0)
                break
            enc.encode(stats, i + 1, 0)
            i += 3
            k += 1
        enc.ac_value(stats, i, k, abs(v))
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)


def _ac_refine_arith(enc, stats, block, ss, se, ah, al):
    def point(v, shift):
        return -((-v) >> shift) if v < 0 else v >> shift
    ke = se
    while ke > 0 and point(block[NATURAL[ke]], al) == 0:
        ke -= 1
    kex = ke
    while kex > 0 and point(block[NATURAL[kex]], ah) == 0:
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(stats, i, 0)
        while True:
            v = abs(block[NATURAL[k]]) >> al
            if v:
                if v >> 1:
                    enc.encode(stats, i + 2, v & 1)
                else:
                    enc.encode(stats, i + 1, 1)
                    enc.encode(enc.fixed, 0, 1 if block[NATURAL[k]] < 0
                               else 0)
                break
            enc.encode(stats, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)


# ---- DCT files --------------------------------------------------------------
def _dct_matrix():
    c = np.zeros((8, 8))
    for k in range(8):
        for n in range(8):
            c[k, n] = (np.sqrt(1 / 8) if k == 0 else np.sqrt(2 / 8)) * \
                np.cos((2 * n + 1) * k * np.pi / 16)
    return c


def _component_blocks(plane, level, quant, rows, cols):
    """(H, W) samples, padded by edge replication to rows x cols blocks,
    -> quantized coefficients (rows, cols, 64) in natural order."""
    h, w = plane.shape
    padded = np.pad(plane, ((0, rows * 8 - h), (0, cols * 8 - w)),
                    mode='edge').astype(np.float64) - level
    b = padded.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    c = _dct_matrix()
    coef = np.einsum('ij,abjk,lk->abil', c, b, c).reshape(rows, cols, 64)
    return np.rint(coef / np.asarray(quant, np.float64)).astype(np.int64)


def dct_jpeg(samples, precision=8, sampling=None, markers=b'', ids=None,
             arithmetic=False, progressive=False, restart=0, quant=None,
             dac=None):
    """(H, W, C) samples (C = 1, 3 or 4) -> a DCT JPEG: SOF1 (Huffman,
    sequential), SOF2 (Huffman, progressive: DC first and refine, AC
    spectral bands and a refinement), SOF9 (arithmetic, sequential) or SOF10
    (arithmetic, progressive, the same scans). ``sampling``: (h, v) of each
    component; each component is box-averaged to its size. ``markers`` go
    after SOI. ``dac``: (dc_l, dc_u, ac_k) written as a DAC segment."""
    samples = np.asarray(samples, np.int64)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, nc = samples.shape
    sampling = sampling or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    level = 1 << (precision - 1)
    if quant is None:
        quant = [[1 + (k % 8 + k // 8) * (3 if precision == 8 else 5)
                  for k in range(64)],
                 [2 + (k % 8 + k // 8) * (4 if precision == 8 else 7)
                  for k in range(64)]]
    blocks = []
    for c in range(nc):
        hs, vs = sampling[c]
        dw, dh = -(-w * hs // hmax), -(-h * vs // vmax)
        plane = samples[..., c]
        fy, fx = vmax // vs, hmax // hs
        ph, pw = -(-h // fy) * fy, -(-w // fx) * fx
        plane = np.pad(plane, ((0, ph - h), (0, pw - w)), mode='edge')
        plane = plane.reshape(ph // fy, fy, pw // fx, fx).mean((1, 3))
        plane = np.rint(plane[:dh, :dw])
        blocks.append(_component_blocks(plane, level, quant[min(c, 1)],
                                        mcuy * vs, mcux * hs))
    marker = {(False, False): 0xC1, (False, True): 0xC2,
              (True, False): 0xC9, (True, True): 0xCA}[arithmetic,
                                                        progressive]
    out = b'\xff\xd8' + markers
    out += dqt(0, quant[0]) + (dqt(1, quant[1]) if nc > 1 else b'')
    out += sof(marker, precision, h, w,
               [(ids[c], *sampling[c], min(c, 1)) for c in range(nc)])
    if restart:
        out += segment(0xDD, struct.pack('>H', restart))
    if arithmetic and dac:
        dc_l, dc_u, ac_k = dac
        out += segment(0xCC, bytes([0, dc_u << 4 | dc_l, 0x10, ac_k,
                                    1, dc_u << 4 | dc_l, 0x11, ac_k]))
    if not progressive:
        scans = [(list(range(nc)), 0, 63, 0, 0)]
    else:
        scans = [(list(range(nc)), 0, 0, 0, 1)]
        scans += [([c], 1, 5, 0, 1) for c in range(nc)]
        scans += [([c], 6, 63, 0, 1) for c in range(nc)]
        scans += [(list(range(nc)), 0, 0, 1, 0)]
        scans += [([c], 1, 63, 1, 0) for c in range(nc)]
    for comps, ss, se, ah, al in scans:
        tables = [(ids[c], min(c, 1), min(c, 1)) for c in comps]
        if not arithmetic:
            out += _huffman_scan(blocks, comps, sampling, mcux, mcuy, ss, se,
                                 ah, al, tables, restart, w, h, hmax, vmax)
        else:
            out += sos(tables, ss, se, ah, al)
            out += _arith_scan(blocks, comps, sampling, mcux, mcuy, ss, se,
                               ah, al, restart, w, h, hmax, vmax,
                               dac or (0, 1, 5))
    return out + b'\xff\xd9'


def _scan_units(blocks, comps, sampling, mcux, mcuy, w, h, hmax, vmax):
    """The scan's MCUs as lists of (component, block)."""
    if len(comps) == 1:
        c = comps[0]
        hs, vs = sampling[c]
        dw, dh = -(-w * hs // hmax), -(-h * vs // vmax)
        return [[(c, blocks[c][by, bx])] for by in range(-(-dh // 8))
                for bx in range(-(-dw // 8))]
    units = []
    for my in range(mcuy):
        for mx in range(mcux):
            unit = []
            for c in comps:
                hs, vs = sampling[c]
                for j in range(vs):
                    for i in range(hs):
                        unit.append((c, blocks[c][my * vs + j, mx * hs + i]))
            units.append(unit)
    return units


def _huffman_scan(blocks, comps, sampling, mcux, mcuy, ss, se, ah, al,
                  tables, restart, w, h, hmax, vmax):
    dc_syms = list(range(16))
    ac_syms = list(range(256))
    dc_codes = huffman_codes(dc_syms)
    ac_codes = huffman_codes(ac_syms)
    head = b''
    for t in sorted({t for _, t, _ in tables}):
        if ss == 0 and ah == 0:
            head += dht(0, t, dc_syms)
        if se > 0:
            head += dht(1, t, ac_syms)
    head += sos(tables, ss, se, ah, al)
    bw = BitWriter()
    data = b''
    pred = {c: 0 for c in comps}
    units = _scan_units(blocks, comps, sampling, mcux, mcuy, w, h, hmax, vmax)
    for n, unit in enumerate(units):
        if restart and n and n % restart == 0:
            data += bw.flush() + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            bw = BitWriter()
            pred = {c: 0 for c in comps}
        for c, block in unit:
            if ss == 0:
                if ah == 0:
                    v = int(block[0]) >> al
                    diff = v - pred[c]
                    pred[c] = v
                    s = category(diff)
                    bw.put(*dc_codes[s])
                    bw.put(magnitude_bits(diff, s), s)
                else:
                    bw.put((int(block[0]) >> al) & 1, 1)
                if se == 0:
                    continue
            first = max(ss, 1)
            if ah == 0:
                run = 0
                last = max([k for k in range(first, se + 1)
                            if abs(int(block[NATURAL[k]])) >> al] or [0])
                for k in range(first, last + 1):
                    a = int(block[NATURAL[k]])
                    v = -((-a) >> al) if a < 0 else a >> al
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        bw.put(*ac_codes[0xF0])
                        run -= 16
                    s = category(v)
                    bw.put(*ac_codes[run << 4 | s])
                    bw.put(magnitude_bits(v, s), s)
                    run = 0
                if last < se:
                    bw.put(*ac_codes[0x00])              # EOB (run 1)
            else:
                raise NotImplementedError('Huffman AC refinement')
    return head + data + bw.flush()


def _arith_scan(blocks, comps, sampling, mcux, mcuy, ss, se, ah, al, restart,
                w, h, hmax, vmax, dac):
    enc = ArithEncoder(*dac)
    dc_stats = {c: [0] * 64 for c in comps}
    ac_stats = {c: [0] * 256 for c in comps}
    # statistics per table: components that share a table share the bins
    dc_by_tbl = {}
    ac_by_tbl = {}
    for c in comps:
        dc_stats[c] = dc_by_tbl.setdefault(min(c, 1), [0] * 64)
        ac_stats[c] = ac_by_tbl.setdefault(min(c, 1), [0] * 256)
    last = {c: 0 for c in comps}
    context = {c: 0 for c in comps}
    units = _scan_units(blocks, comps, sampling, mcux, mcuy, w, h, hmax, vmax)

    def reset():
        for t in dc_by_tbl.values():
            t[:] = [0] * 64
        for t in ac_by_tbl.values():
            t[:] = [0] * 256
        for c in comps:
            last[c] = 0
            context[c] = 0

    for n, unit in enumerate(units):
        if restart and n and n % restart == 0:
            enc.finish()
            enc.out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            enc.start()
            reset()
        for c, block in unit:
            if ss == 0:
                if ah == 0:
                    v = int(block[0]) >> al
                    diff = v - last[c]
                    if diff:
                        last[c] = v
                    enc.dc(dc_stats[c], context, c, diff)
                else:
                    enc.encode(enc.fixed, 0, (int(block[0]) >> al) & 1)
                if se == 0:
                    continue
            block = [int(x) for x in block]
            if ah == 0:
                _ac_first_arith(enc, ac_stats[c], block, max(ss, 1), se, al)
            else:
                _ac_refine_arith(enc, ac_stats[c], block, ss, se, ah, al)
    enc.finish()
    return bytes(enc.out)


# ---- lossless files (SOF3) --------------------------------------------------
def lossless_jpeg(samples, precision=8, predictor=1, pt=0, restart=0,
                  markers=b'', ids=None):
    """(H, W, C) samples in ``precision`` bits -> a lossless JPEG (SOF3), the
    components interleaved at 1 x 1, ``predictor`` 1-7, point transform
    ``pt``, a restart every ``restart`` MCUs (a multiple of the width)."""
    samples = np.asarray(samples, np.int64)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, nc = samples.shape
    ids = ids or list(range(1, nc + 1))
    x = samples >> pt
    syms = list(range(17))
    codes = huffman_codes(syms)
    out = b'\xff\xd8' + markers
    out += sof(0xC3, precision, h, w, [(ids[c], 1, 1, 0) for c in range(nc)])
    out += dht(0, 0, syms)
    if restart:
        out += segment(0xDD, struct.pack('>H', restart))
    out += sos([(ids[c], 0, 0) for c in range(nc)], predictor, 0, 0, pt)
    bw = BitWriter()
    data = b''
    first_row = True
    for y in range(h):
        if restart and y and (y * w) % restart == 0:
            data += bw.flush() + bytes([0xFF, 0xD0 + ((y * w) // restart - 1)
                                        % 8])
            bw = BitWriter()
            first_row = True
        for xx in range(w):
            for c in range(nc):
                if first_row:
                    pred = (1 << (precision - pt - 1)) if xx == 0 else \
                        x[y, xx - 1, c]
                elif xx == 0:
                    pred = x[y - 1, 0, c]
                else:
                    ra, rb, rc = x[y, xx - 1, c], x[y - 1, xx, c], \
                        x[y - 1, xx - 1, c]
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                            5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1),
                            7: (ra + rb) >> 1}[predictor]
                diff = int(x[y, xx, c] - pred) & 0xFFFF
                if diff >= 0x8000:
                    diff -= 0x10000
                if diff == -0x8000:
                    bw.put(*codes[16])
                    continue
                s = category(diff)
                bw.put(*codes[s])
                bw.put(magnitude_bits(diff, s), s)
        first_row = False
    return out + data + bw.flush() + b'\xff\xd9'
