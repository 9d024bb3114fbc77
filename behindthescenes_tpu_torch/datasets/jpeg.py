"""Baseline JPEG reading and writing in numpy.

The GPU machine has no OpenCV and no PIL, so the port reads the KITTI raw
and RealEstate10K frames here (no JAX counterpart; the JAX loaders call
`cv2.imread`, which decodes through libjpeg-turbo with its defaults).

`read_jpeg` decodes baseline sequential Huffman files with 8-bit samples,
one component (grey, returned as three equal channels, as `cv2.imread`
gives it) or three, luma sampled 1x1, 2x1 or 2x2 with chroma at 1x1, with
or without restart intervals, at any size. It is bit-equal to
libjpeg-turbo's default decode:
- the ISLOW integer IDCT of `jidctint.c` (CONST_BITS 13, PASS1_BITS 2,
  rounding descales), its output read through the `range_limit` table
  with the `& RANGE_MASK` wrap;
- fancy upsampling (`jdsample.c`): h2v1 the 3/4-1/4 triangle with biases
  +1/+2, h2v2 the vertical 3/4-1/4 first and then the horizontal pass
  with biases +8/+7; the first and last columns are those of the
  component's downsampled width, and the context rows above the first
  and below the last sample row repeat the edge rows (`jdmainct.c`);
- the fixed-point YCbCr -> RGB tables of `jdcolor.c` (SCALEBITS 16,
  ONE_HALF rounding, G from the summed Cb and Cr terms).
The entropy decode is sequential Python: one 16-bit lookahead lookup a
symbol, which for most AC symbols also yields the coefficient's value.
Everything after it (dequantisation, IDCT, upsampling, colour) runs in
numpy over all blocks at once. Progressive, arithmetic-coded, lossless
and 12-bit files raise ValueError with the file's name.

`write_jpeg` writes what `cv2.imwrite` writes by default: baseline, the
Annex K tables scaled to the quality, 4:2:0, the standard Huffman
tables, no restart markers. Its bytes differ from OpenCV's (a float DCT,
plain 2x2 means), but any decoder reads them, and `read_jpeg` reads them
as libjpeg-turbo does.
"""
from __future__ import annotations

import functools
import struct

import numpy as np

# Position in the 8x8 block (row-major) of the k-th zigzag coefficient.
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# SOFn markers that this decoder refuses, with what they are.
_REFUSED_SOF = {0xC2: "progressive", 0xC3: "lossless",
                0xC5: "differential sequential",
                0xC6: "differential progressive",
                0xC7: "differential lossless",
                0xC9: "arithmetic-coded sequential",
                0xCA: "arithmetic-coded progressive",
                0xCB: "arithmetic-coded lossless",
                0xCD: "arithmetic-coded differential sequential",
                0xCE: "arithmetic-coded differential progressive",
                0xCF: "arithmetic-coded differential lossless"}

# jidctint.c's constants: FIX(x) = round(x * 2**13).
_CONST_BITS = 13
_PASS1_BITS = 2
_FIX_0_298631336 = 2446
_FIX_0_390180644 = 3196
_FIX_0_541196100 = 4433
_FIX_0_765366865 = 6270
_FIX_0_899976223 = 7373
_FIX_1_175875602 = 9633
_FIX_1_501321110 = 12299
_FIX_1_847759065 = 15137
_FIX_1_961570560 = 16069
_FIX_2_053119869 = 16819
_FIX_2_562915447 = 20995
_FIX_3_072711026 = 25172


def _idct_range_limit() -> np.ndarray:
    """The post-IDCT part of jdmaster.c's sample_range_limit table,
    indexed by (x & 1023) for an IDCT output x centred on 0: x + 128 for
    x in [-128, 127], 255 up to 511, then 0 (the wrap) down to -129."""
    table = np.zeros(1024, np.uint8)
    table[:128] = np.arange(128, 256)
    table[128:512] = 255
    table[896:] = np.arange(128)
    return table


_RANGE_LIMIT = _idct_range_limit()


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c, pass1: bool):
    """One pass of jpeg_idct_islow over the last axis (8 values), int64:
    the even part, the odd part and the descale of that pass."""
    z2, z3 = c[..., 2], c[..., 6]
    z1 = (z2 + z3) * _FIX_0_541196100
    tmp2 = z1 + z3 * -_FIX_1_847759065
    tmp3 = z1 + z2 * _FIX_0_765366865
    tmp0 = (c[..., 0] + c[..., 4]) << _CONST_BITS
    tmp1 = (c[..., 0] - c[..., 4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = c[..., 7], c[..., 5], c[..., 3], c[..., 1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _FIX_1_175875602
    tmp0 = tmp0 * _FIX_0_298631336
    tmp1 = tmp1 * _FIX_2_053119869
    tmp2 = tmp2 * _FIX_3_072711026
    tmp3 = tmp3 * _FIX_1_501321110
    z1 = z1 * -_FIX_0_899976223
    z2 = z2 * -_FIX_2_562915447
    z3 = z3 * -_FIX_1_961570560 + z5
    z4 = z4 * -_FIX_0_390180644 + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4

    n = _CONST_BITS - _PASS1_BITS if pass1 \
        else _CONST_BITS + _PASS1_BITS + 3
    return _descale(np.stack([tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1,
                              tmp13 + tmp0, tmp13 - tmp0, tmp12 - tmp1,
                              tmp11 - tmp2, tmp10 - tmp3], axis=-1), n)


def idct_islow_raw(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Dequantise and inverse-transform blocks (..., 64) of coefficients
    in natural order: jpeg_idct_islow's int64 outputs (..., 8, 8),
    centred on 0, before the range limit (columns first, then rows)."""
    deq = coefs.astype(np.int64) * qtable.astype(np.int64)
    blocks = deq.reshape(coefs.shape[:-1] + (8, 8))
    # Pass 1 runs down each column; the workspace is its transpose.
    ws = _idct_1d(np.swapaxes(blocks, -1, -2), pass1=True)
    return _idct_1d(np.swapaxes(ws, -1, -2), pass1=False)


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """uint8 samples (..., 8, 8) as jpeg_idct_islow writes them: the raw
    outputs through the range limit."""
    return _RANGE_LIMIT[idct_islow_raw(coefs, qtable) & 1023]


# --------------------------------------------------------------- entropy

def _huffman_lookup(bits, values) -> tuple:
    """A DHT table -> (length, symbol) for every 16-bit lookahead, as two
    arrays (length 0 where no code matches: a corrupt stream)."""
    lengths = np.zeros(1 << 16, np.int64)
    symbols = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            lo = code << (16 - n)
            hi = (code + 1) << (16 - n)
            lengths[lo:hi] = n
            symbols[lo:hi] = values[k]
            code += 1
            k += 1
        code <<= 1
    return lengths, symbols


@functools.lru_cache(maxsize=32)
def _entry_table(counts: tuple, values: tuple, ac: bool) -> list:
    """One entry a 16-bit lookahead: (bits consumed, run, value, extra).
    Where the code and its magnitude bits fit in the 16 bits, the entry
    is complete (extra = 0); else value is 0 and extra the count of
    magnitude bits still to read. For AC tables the second field is the
    count of positions the symbol moves: its zero run plus one, 16 for
    ZRL and 0 for EOB."""
    lengths, symbols = _huffman_lookup(counts, values)
    idx = np.arange(1 << 16, dtype=np.int64)
    s = symbols & 15 if ac else symbols
    run = symbols >> 4 if ac else np.zeros_like(symbols)
    total = lengths + s
    fits = (total <= 16) & (lengths > 0)
    raw = (idx >> np.maximum(16 - total, 0)) & ((1 << s) - 1)
    val = np.where(raw < (1 << np.maximum(s - 1, 0)),
                   raw - (1 << s) + 1, raw)
    val = np.where(s == 0, 0, val)
    consumed = np.where(fits, total, lengths)
    extra = np.where(fits, 0, s)
    val = np.where(fits, val, 0)
    if ac:
        eob = (s == 0) & (run == 0)
        zrl = (s == 0) & (run == 15)
        run = np.where(eob, 0, np.where(zrl, 16, run + 1))
    return list(zip(consumed.tolist(), run.tolist(), val.tolist(),
                    extra.tolist()))


def _segment_words(data: bytes) -> list:
    """The entropy-coded bytes (stuffing removed) as the big-endian
    32-bit word that starts at each byte, zeros past the end."""
    b = np.frombuffer(data, np.uint8)
    # Byte stuffing: every 0xFF is followed by a 0x00 that is not data.
    ff = np.flatnonzero(b[:-1] == 0xFF)
    keep = np.ones(b.size, bool)
    keep[ff + 1] = False
    b = np.concatenate([b[keep].astype(np.uint32), np.zeros(4, np.uint32)])
    words = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    return words.tolist()


def _decode_segment(words, units, coef_idx, coef_val):
    """Decode one restart interval: `units` lists, for every block in
    stream order, (flat coefficient offset, DC table, AC table,
    predictor slot). Appends each coefficient's flat (zigzag) index and
    value to coef_idx / coef_val (a ZRL appends a zero)."""
    pos = 0
    pred = [0, 0, 0, 0]
    append_i, append_v = coef_idx.append, coef_val.append
    for base, dct, act, slot in units:
        consumed, _, diff, s = dct[
            (words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        pos += consumed
        if s:
            raw = (words[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            diff = raw - (1 << s) + 1 if raw < (1 << (s - 1)) else raw
        pred[slot] += diff
        append_i(base)
        append_v(pred[slot])
        k = base
        end = base + 63
        while k < end:
            consumed, adv, val, s = act[
                (words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            pos += consumed
            if not adv:
                break
            if s:
                raw = (words[pos >> 3] >> (32 - (pos & 7) - s)) \
                    & ((1 << s) - 1)
                pos += s
                val = raw - (1 << s) + 1 if raw < (1 << (s - 1)) else raw
            k += adv
            append_i(k)
            append_v(val)


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _parse(data: bytes, path):
    """Markers -> (frame header, components, quant tables, scans), where
    a scan is (component indices, table ids, entropy-coded segments
    split at RST markers, restart interval)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    qtables, dc_huff, ac_huff = {}, {}, {}
    frame, comps, scans = None, [], []
    restart = 0
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: expected a marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:          # fill byte
            pos -= 1
            continue
        if marker == 0xD9:          # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _REFUSED_SOF:
            raise ValueError(f"{path}: {_REFUSED_SOF[marker]} JPEG is not "
                             "read (baseline sequential Huffman only)")
        if marker in (0xC0, 0xC1):
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{path}: {precision}-bit JPEG samples are "
                                 "not read (8-bit only)")
            if nc not in (1, 3):
                raise ValueError(f"{path}: {nc} components (1 or 3 read)")
            if h == 0:
                raise ValueError(f"{path}: height set by DNL is not read")
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            frame = (h, w)
        elif marker == 0xC4:        # DHT
            p = 0
            while p < len(body):
                tc_th = body[p]
                counts = list(body[p + 1:p + 17])
                values = list(body[p + 17:p + 17 + sum(counts)])
                (ac_huff if tc_th >> 4 else dc_huff)[tc_th & 15] = \
                    (tuple(counts), tuple(values))
                p += 17 + sum(counts)
        elif marker == 0xDB:        # DQT
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                if pq:
                    vals = struct.unpack(">64H", body[p + 1:p + 129])
                    p += 129
                else:
                    vals = tuple(body[p + 1:p + 65])
                    p += 65
                table = np.zeros(64, np.int64)
                table[NATURAL_ORDER] = vals
                qtables[tq] = table
        elif marker == 0xDD:        # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:        # SOS
            if frame is None:
                raise ValueError(f"{path}: SOS before SOF")
            ns = body[0]
            sel = []
            for i in range(ns):
                cid, tables = body[1 + 2 * i:3 + 2 * i]
                ci = next(j for j, c in enumerate(comps) if c.id == cid)
                sel.append((ci, tables >> 4, tables & 15))
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or ahal != 0:
                raise ValueError(f"{path}: spectral selection or successive"
                                 " approximation in a sequential scan")
            # The entropy-coded data runs to the next marker that is not
            # a stuffed 0xFF00 or an RSTn; RSTn split it into segments.
            segments, start = [], pos
            while True:
                j = data.find(b"\xff", pos)
                if j < 0 or j + 1 >= n:
                    raise ValueError(f"{path}: scan data runs past the end")
                nxt = data[j + 1]
                if nxt == 0x00 or nxt == 0xFF:
                    pos = j + 1 if nxt == 0xFF else j + 2
                    continue
                if 0xD0 <= nxt <= 0xD7:
                    segments.append(data[start:j])
                    pos = start = j + 2
                    continue
                segments.append(data[start:j])
                pos = j
                break
            scans.append((sel, dict(dc_huff), dict(ac_huff), segments,
                          restart))
    if frame is None or not scans:
        raise ValueError(f"{path}: no frame or no scan")
    return frame, comps, qtables, scans


def _decode_coefficients(frame, comps, scans, path):
    """Every component's quantised coefficients in natural order, as
    (blocks_h, blocks_w, 64) int64 grids covering whole MCUs."""
    h, w = frame
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = _cdiv(w, 8 * hmax)
    mcuy = _cdiv(h, 8 * vmax)
    grids = [np.zeros((mcuy * c.v, mcux * c.h, 64), np.int64)
             for c in comps]
    for sel, dc_huff, ac_huff, segments, restart in scans:
        # Block order of the scan: (component, block row, block col).
        if len(sel) == 1:
            ci = sel[0][0]
            c = comps[ci]
            # A single-component scan covers only the component's own
            # blocks, not whole MCUs.
            bw = _cdiv(_cdiv(w * c.h, hmax), 8)
            bh = _cdiv(_cdiv(h * c.v, vmax), 8)
            by, bx = np.divmod(np.arange(bh * bw), bw)
            order = [(ci, y, x) for y, x in zip(by.tolist(), bx.tolist())]
            per_unit = 1
        else:
            order = []
            for my in range(mcuy):
                for mx in range(mcux):
                    for ci, _, _ in sel:
                        c = comps[ci]
                        for v in range(c.v):
                            for u in range(c.h):
                                order.append((ci, my * c.v + v,
                                              mx * c.h + u))
            per_unit = sum(comps[ci].h * comps[ci].v for ci, _, _ in sel)
        slot_of = {ci: k for k, (ci, _, _) in enumerate(sel)}
        tabs = {ci: (_entry_table(*dc_huff[td], ac=False),
                     _entry_table(*ac_huff[ta], ac=True))
                for ci, td, ta in sel}
        # Offsets into one flat coefficient array per scan.
        sizes = [grids[ci].size for ci, _, _ in sel]
        starts = dict(zip([ci for ci, _, _ in sel],
                          np.concatenate([[0], np.cumsum(sizes)[:-1]])
                          .tolist()))
        units = [(starts[ci] + (y * grids[ci].shape[1] + x) * 64,
                  tabs[ci][0], tabs[ci][1], slot_of[ci])
                 for ci, y, x in order]
        step = restart * per_unit if restart else len(units)
        if len(segments) != _cdiv(len(units), step):
            raise ValueError(f"{path}: {len(segments)} restart intervals "
                             f"for {len(units)} blocks")
        idx, val = [], []
        for s, seg in enumerate(segments):
            _decode_segment(_segment_words(seg),
                            units[s * step:(s + 1) * step], idx, val)
        flat = np.zeros(sum(sizes), np.int64)
        if idx:
            idx = np.asarray(idx, np.int64)
            # Zigzag position -> natural position inside the block.
            idx = idx - idx % 64 + NATURAL_ORDER[idx % 64]
            flat[idx] = val
        for ci, _, _ in sel:
            g = grids[ci]
            g[...] = flat[starts[ci]:starts[ci] + g.size].reshape(g.shape)
    return grids, (hmax, vmax)


# ---------------------------------------------------------------- pixels

def _component_planes(grids, comps, qtables, frame, hv_max):
    """Each component's samples (ds_h, ds_w) uint8: the IDCT of its
    blocks, cut to its downsampled size ceil(size * factor / max)."""
    h, w = frame
    hmax, vmax = hv_max
    planes = []
    for g, c in zip(grids, comps):
        pix = idct_islow(g, qtables[c.tq])          # (bh, bw, 8, 8)
        bh, bw = g.shape[:2]
        plane = pix.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        dh = _cdiv(h * c.v, vmax)
        dw = _cdiv(w * c.h, hmax)
        planes.append(plane[:dh, :dw])
    return planes


def _fancy_h2(rows: np.ndarray, bias_lo: int, bias_hi: int,
              shift: int) -> np.ndarray:
    """The horizontal triangle filter of jdsample.c on rows (n, dw) of
    int64 (column sums for h2v2, samples for h2v1): output 2i is
    (3 x[i] + x[i-1] + bias_lo) >> shift, 2i + 1 is
    (3 x[i] + x[i+1] + bias_hi) >> shift, with x[-1] = x[0] and
    x[dw] = x[dw - 1] (the edge cases (4 x + bias) >> shift)."""
    left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
    out = np.empty((rows.shape[0], rows.shape[1] * 2), np.int64)
    out[:, 0::2] = (3 * rows + left + bias_lo) >> shift
    out[:, 1::2] = (3 * rows + right + bias_hi) >> shift
    return out


def upsample_fancy(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """Upsample a chroma plane (dh, dw) by (fv, fh) in {(1, 1), (1, 2),
    (2, 2)} as libjpeg-turbo's h2v1 / h2v2 fancy upsamplers do."""
    x = plane.astype(np.int64)
    if (fh, fv) == (1, 1):
        return plane
    if (fh, fv) == (2, 1):
        return _fancy_h2(x, 1, 2, 2).astype(np.uint8)
    if (fh, fv) == (2, 2):
        above = np.concatenate([x[:1], x[:-1]], axis=0)
        below = np.concatenate([x[1:], x[-1:]], axis=0)
        # Output row 2i uses the row above, 2i + 1 the row below.
        colsum = np.empty((x.shape[0] * 2, x.shape[1]), np.int64)
        colsum[0::2] = 3 * x + above
        colsum[1::2] = 3 * x + below
        return _fancy_h2(colsum, 8, 7, 4).astype(np.uint8)
    raise ValueError(f"chroma upsampling {fh}x{fv} is not read")


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table, indexed by the sample 0..255."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """uint8 planes -> uint8 RGB (h, w, 3) through jdcolor.c's tables and
    its clamp to [0, 255]."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, path="<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 (h, w, 3) RGB (see the module docstring)."""
    frame, comps, qtables, scans = _parse(data, path)
    h, w = frame
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    if len(comps) == 3:
        sub = [(c.h, c.v) for c in comps]
        if sub[1] != (1, 1) or sub[2] != (1, 1) or sub[0] not in (
                (1, 1), (2, 1), (2, 2)):
            raise ValueError(f"{path}: sampling factors {sub} are not read "
                             "(Y 1x1, 2x1 or 2x2 with chroma 1x1)")
    for c in comps:
        if c.tq not in qtables:
            raise ValueError(f"{path}: quantisation table {c.tq} missing")
    for sel, dc_huff, ac_huff, _, _ in scans:
        for _, td, ta in sel:
            if td not in dc_huff or ta not in ac_huff:
                raise ValueError(f"{path}: Huffman table missing")
    grids, hv = _decode_coefficients(frame, comps, scans, path)
    planes = _component_planes(grids, comps, qtables, frame, hv)
    if len(comps) == 1:
        grey = planes[0][:h, :w]
        return np.repeat(grey[..., None], 3, axis=2)
    cb = upsample_fancy(planes[1], hmax, vmax)[:h, :w]
    cr = upsample_fancy(planes[2], hmax, vmax)[:h, :w]
    return ycc_to_rgb(planes[0][:h, :w], cb, cr)


def read_jpeg(path) -> np.ndarray:
    """A baseline JPEG file as uint8 (h, w, 3) RGB: `cv2.imread(path)`
    with its channels in RGB order."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, str(path))


# ---------------------------------------------------------------- writer

# ITU T.81 Annex K.1: luminance and chrominance quantisation tables, in
# natural order.
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])

# Annex K.3: the standard Huffman tables (code counts by length, values).
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c's jpeg_quality_scaling and jpeg_add_quant_table with
    force_baseline: the table scaled and clamped to [1, 255]."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _code_table(counts, values):
    """Huffman (code, length) for each symbol 0..255 of a DHT table."""
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            codes[values[k]] = code
            lengths[values[k]] = n
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _fdct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II as a matrix (JPEG's FDCT scaled by
    1/8 in two dimensions is this applied on both sides)."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    m = np.cos((2 * n + 1) * k * np.pi / 16) * 0.5
    m[0] /= np.sqrt(2.0)
    return m


_FDCT = _fdct_matrix()


def _blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Edge-replicate a plane to (bh*8, bw*8) and cut it into (bh, bw,
    64) blocks in natural order."""
    h, w = plane.shape
    plane = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    return plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(
        bh, bw, 64)


def _quantise(blocks: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Level-shift, DCT and round-divide (..., 64) samples: quantised
    coefficients in natural order, int64."""
    x = blocks.reshape(blocks.shape[:-1] + (8, 8)) - 128.0
    coef = _FDCT @ x @ _FDCT.T
    return np.rint(coef.reshape(blocks.shape) / qtable).astype(np.int64)


def _magnitude(v):
    """(category s, the s magnitude bits) of each value (JPEG's
    one's-complement for negative values)."""
    a = np.abs(v)
    s = np.zeros(v.shape, np.int64)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v < 0, v + (1 << s) - 1, v)
    return s, bits


def _scan_symbols(zz, kind, dc_codes, ac_codes):
    """Blocks (n, 64) in zigzag and stream order, each with its table
    kind (0 luma, 1 chroma) -> the (code, length) of every symbol with
    its magnitude bits appended, in stream order. dc_codes and ac_codes
    are (codes, lengths), each (2, 256)."""
    n = zz.shape[0]
    keys, codes, lengths = [], [], []

    dc_s, dc_bits = _magnitude(zz[:, 0])
    keys.append(np.arange(n) * 512)
    codes.append((dc_codes[0][kind, dc_s] << dc_s) | dc_bits)
    lengths.append(dc_codes[1][kind, dc_s] + dc_s)

    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k]
    # Zero run before each nonzero: the distance to the previous nonzero
    # of the same block (or to the DC).
    prev = np.concatenate([[0], k[:-1]])
    prev[np.concatenate([[True], blk[1:] != blk[:-1]])] = 0
    run = k - prev - 1
    n_zrl = run // 16
    s, bits = _magnitude(v)
    sym = ((run % 16) << 4) | s
    kb = kind[blk]
    keys.append(blk * 512 + k * 8 + 4)
    codes.append((ac_codes[0][kb, sym] << s) | bits)
    lengths.append(ac_codes[1][kb, sym] + s)
    # ZRL (sixteen zeros) symbols before a nonzero, at most three.
    rep = np.repeat(np.arange(blk.size), n_zrl)
    j = np.arange(rep.size) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
    keys.append(blk[rep] * 512 + k[rep] * 8 + j)
    codes.append(ac_codes[0][kb[rep], 0xF0])
    lengths.append(ac_codes[1][kb[rep], 0xF0])
    # EOB where the block's last coefficient is zero.
    eob = np.flatnonzero(zz[:, 63] == 0)
    keys.append(eob * 512 + 511)
    codes.append(ac_codes[0][kind[eob], 0x00])
    lengths.append(ac_codes[1][kind[eob], 0x00])

    order = np.argsort(np.concatenate(keys), kind="stable")
    return np.concatenate(codes)[order], np.concatenate(lengths)[order]


def _pack_bits(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate variable-length codes MSB first, pad the last byte
    with ones and stuff a zero after every 0xFF."""
    total = int(lengths.sum())
    ends = np.cumsum(lengths)
    owner = np.repeat(np.arange(codes.size), lengths)
    shift = ends[owner] - 1 - np.arange(total)
    bits = ((codes[owner] >> shift) & 1).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """uint8 RGB (h, w, 3) -> baseline JPEG bytes, 4:2:0 (see the module
    docstring)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 (h, w, 3), not "
                         f"{rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    x = rgb.astype(np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    mcux, mcuy = _cdiv(w, 16), _cdiv(h, 16)
    # 2x2 means of the edge-replicated chroma planes.
    ch, cw = mcuy * 16, mcux * 16

    def down(p):
        p = np.pad(p, ((0, ch - h), (0, cw - w)), mode="edge")
        return p.reshape(ch // 2, 2, cw // 2, 2).mean(axis=(1, 3))

    q_luma = quality_table(_STD_LUMA_Q, quality)
    q_chroma = quality_table(_STD_CHROMA_Q, quality)
    yq = _quantise(_blocks(y, mcuy * 2, mcux * 2), q_luma)
    cbq = _quantise(_blocks(down(cb), mcuy, mcux), q_chroma)
    crq = _quantise(_blocks(down(cr), mcuy, mcux), q_chroma)

    # Stream order: per MCU the four Y blocks (raster), Cb, Cr.
    yb = yq.reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4) \
        .reshape(mcuy, mcux, 4, 64)
    mcus = np.concatenate([yb, cbq[:, :, None], crq[:, :, None]], axis=2)
    mcus = mcus.reshape(-1, 6, 64)
    zz = mcus[..., NATURAL_ORDER].copy()
    # DC differences per component along the stream.
    for comp in (slice(0, 4), slice(4, 5), slice(5, 6)):
        dc = zz[:, comp, 0].reshape(-1)
        diff = np.diff(dc, prepend=0)
        zz[:, comp, 0] = diff.reshape(zz[:, comp, 0].shape)
    dc_tabs = np.stack([np.stack(_code_table(*spec))
                        for spec in (_DC_LUMA, _DC_CHROMA)], axis=1)
    ac_tabs = np.stack([np.stack(_code_table(*spec))
                        for spec in (_AC_LUMA, _AC_CHROMA)], axis=1)
    kind = np.tile(np.array([0, 0, 0, 0, 1, 1]), zz.shape[0])
    codes, lengths = _scan_symbols(zz.reshape(-1, 64), kind, dc_tabs,
                                   ac_tabs)

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    def dqt(tq, table):
        return bytes([tq]) + bytes(table[NATURAL_ORDER].astype(np.uint8))

    def dht(tc_th, spec):
        counts, values = spec
        return bytes([tc_th]) + bytes(counts) + bytes(values)

    out = [b"\xff\xd8",
           seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           seg(0xDB, dqt(0, q_luma) + dqt(1, q_chroma)),
           seg(0xC0, struct.pack(">BHHB", 8, h, w, 3)
               + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
           seg(0xC4, dht(0x00, _DC_LUMA) + dht(0x10, _AC_LUMA)
               + dht(0x01, _DC_CHROMA) + dht(0x11, _AC_CHROMA)),
           seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
           _pack_bits(codes, lengths), b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path, rgb: np.ndarray, quality: int = 95) -> None:
    """Write uint8 RGB (h, w, 3) as a baseline 4:2:0 JPEG."""
    data = encode_jpeg(rgb, quality)
    with open(path, "wb") as f:
        f.write(data)
