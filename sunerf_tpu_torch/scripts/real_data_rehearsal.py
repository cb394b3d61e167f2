"""Real-data dress rehearsal, as far as offline allows, on the port
(scripts/real_data_rehearsal.py of the JAX package).

No network: real JSOC exports cannot be fetched. Instead this runs the
full real-data path on JSOC-shaped inputs: SimpleStar AIA renders
re-packaged as lev1-style tile-compressed FITS (RICE_1 tiles, float
quantization with SUBTRACTIVE_DITHER_2, the JSOC default, so the seeded
dither decode runs; per-tile ZSCALE/ZZERO columns; QUALITY/T_OBS/WAVELNTH
cards), then `prep sdo` (degradation correction by table, resample, SDO
norms) -> emission training -> held-out metrics. No real frames are needed:
the script synthesizes its own.

The compressor (write_tile_compressed) is this module's own copy of the
JAX package's test-side writer (tests/test_fits_compressed.py, which
imports the JAX package), written independently of the port's reader
(data/fits.py, native/rice.cpp), so the reader is exercised against files
its own code did not write. Training runs the port's Trainer on --device
(K1 + K2 on the card, scripts/occupancy_ablation.run_variant).

Usage: python -m sunerf_tpu_torch.scripts.real_data_rehearsal [--steps 1500]
           [--resolution 128] [--out FILE] [--device cuda]
Prints one JSON line (main returns it, with the launches by kernel name).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import zlib
from datetime import datetime

import numpy as np

BLOCK, CARD = 2880, 80
_RICE_PARAMS = {1: (3, 6), 2: (4, 14), 4: (5, 25)}


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value, nbits):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def bytes(self):
        if self.n:
            pad = 8 - self.n
            return bytes(self.out) + bytes([(self.acc << pad) & 0xFF])
        return bytes(self.out)


def rice_compress(pixels: np.ndarray, bytepix: int = 2, nblock: int = 32) -> bytes:
    """RICE_1 encoder: seed pixel, then per block a split position fs (or
    the verbatim escape) and folded first differences."""
    fsbits, fsmax = _RICE_PARAMS[bytepix]
    bbits = bytepix * 8
    mask = (1 << bbits) - 1
    half = 1 << (bbits - 1)
    w = _BitWriter()

    vals = [int(v) & mask for v in np.asarray(pixels).ravel()]
    w.put(vals[0], bbits)
    last = vals[0]
    for start in range(0, len(vals), nblock):
        block = vals[start:start + nblock]
        codes = []
        for v in block:
            delta = (v - last) & mask
            if delta >= half:
                delta -= 1 << bbits  # signed wrap
            codes.append(2 * delta if delta >= 0 else -2 * delta - 1)
            last = v
        if max(codes) == 0:
            w.put(0, fsbits)  # zero-entropy block
            continue
        # split so the unary part stays short; fall back to verbatim
        fs = max(0, max(codes).bit_length() - 3)
        if fs >= fsmax or max(c >> fs for c in codes) > 24:
            w.put(fsmax + 1, fsbits)
            for c in codes:
                w.put(c, bbits)
        else:
            w.put(fs + 1, fsbits)
            for c in codes:
                w.put(1, (c >> fs) + 1)  # unary: zeros then a 1
                if fs:
                    w.put(c & ((1 << fs) - 1), fs)
    return w.bytes()


def _card(key, value, string=False):
    if string:
        body = f"'{value:<8}'"
    elif isinstance(value, bool):
        body = f"{'T' if value else 'F':>20}"
    elif isinstance(value, float):
        body = f'{value:>20.13G}'
    else:
        body = f'{value:>20}'
    return f'{key:<8}= {body}'.ljust(CARD).encode()


def _pad(b: bytes) -> bytes:
    return b + b'\0' * (-len(b) % BLOCK)


def _dither_randoms():
    """The published cfitsio dither sequence (Pence, Seaman & White 2013
    §4): the Park-Miller minimal-standard generator in exact integer
    arithmetic."""
    seed, m = 1, 2147483647
    vals = []
    for _ in range(10000):
        seed = (16807 * seed) % m
        vals.append(seed / m)
    return np.asarray(vals)


class _DitherWalk:
    """Per-tile walker over the dither sequence: start index (zdither0 - 1
    + row - 1) mod 10000; the pixel pointer starts at int(rand[i0] * 500)
    and reseeds on wrap; it advances for every pixel, null and zero codes
    included."""

    def __init__(self, zdither0, tile_row):
        self.rand = _dither_randoms()
        self.i0 = (zdither0 - 1 + tile_row - 1) % 10000
        self.ptr = int(self.rand[self.i0] * 500.0)

    def next(self):
        v = self.rand[self.ptr]
        self.ptr += 1
        if self.ptr == 10000:
            self.i0 = (self.i0 + 1) % 10000
            self.ptr = int(self.rand[self.i0] * 500.0)
        return v


def dither_quantize(tile, zscale, zzero, tile_row, zdither0,
                    method='SUBTRACTIVE_DITHER_1'):
    """Quantize one tile the cfitsio way -> (int32 codes, the float64 values
    a cfitsio decode gives back). NaNs encode as the null code -2147483647;
    under DITHER_2, exact zeros encode as -2147483646 and decode to 0.0."""
    flat = np.asarray(tile, np.float64).ravel()
    walk = _DitherWalk(zdither0, tile_row)
    codes = np.empty(flat.size, np.int32)
    truth = np.empty(flat.size, np.float64)
    for i, v in enumerate(flat):
        r = walk.next()
        if np.isnan(v):
            codes[i], truth[i] = -2147483647, np.nan
        elif method == 'SUBTRACTIVE_DITHER_2' and v == 0.0:
            codes[i], truth[i] = -2147483646, 0.0
        else:
            c = int(np.round((v - zzero) / zscale + r - 0.5))
            codes[i] = c
            truth[i] = (c - (r - 0.5)) * zscale + zzero
    return codes.reshape(np.shape(tile)), truth.reshape(np.shape(tile))


def write_tile_compressed(path, image, zcmptype='RICE_1', bytepix=None,
                          tile_rows=1, quantize=None, extra_cards=(),
                          dither=None, zdither0=1):
    """A ZIMAGE bintable FITS: one tile per `tile_rows` image rows, optional
    float quantization with per-tile ZSCALE/ZZERO (and optional subtractive
    dithering). With dither set, returns the float64 image an exact cfitsio
    decode would produce."""
    image = np.asarray(image)
    h, wdt = image.shape
    if quantize is None:
        zbitpix = {np.dtype(np.int16): 16, np.dtype(np.int32): 32,
                   np.dtype(np.uint8): 8}[image.dtype]
        bytepix = bytepix or image.dtype.itemsize
    else:
        zbitpix = -32
        bytepix = 4

    truth = np.empty((h, wdt), np.float64) if dither else None
    tiles, scales = [], []
    for r0 in range(0, h, tile_rows):
        tile = image[r0:r0 + tile_rows]
        if quantize is not None:
            finite = tile[np.isfinite(tile)]
            zzero = float(finite.min()) if finite.size else 0.0
            zscale = float(quantize)
            if dither:
                ints, t = dither_quantize(tile, zscale, zzero, r0 // tile_rows + 1, zdither0,
                                          method=dither)
                truth[r0:r0 + tile_rows] = t
            else:
                ints = np.round((tile.astype(np.float64) - zzero) / zscale).astype(np.int32)
            scales.append((zscale, zzero))
            tile = ints
        if zcmptype == 'RICE_1':
            tiles.append(rice_compress(tile, bytepix))
        elif zcmptype == 'GZIP_1':
            be = tile.astype(f'>i{tile.dtype.itemsize}')
            tiles.append(zlib.compress(be.tobytes()))
        else:
            raise ValueError(zcmptype)

    # heap: concatenated var-length arrays; table rows: P descriptor (+ D,D)
    heap = bytearray()
    rows = bytearray()
    for i, t in enumerate(tiles):
        rows += np.asarray([len(t), len(heap)], '>i4').tobytes()
        if quantize is not None:
            rows += np.asarray(scales[i], '>f8').tobytes()
        heap += t
    naxis1 = 8 + (16 if quantize is not None else 0)

    cards = [
        _card('XTENSION', 'BINTABLE', string=True),
        _card('BITPIX', 8), _card('NAXIS', 2),
        _card('NAXIS1', naxis1), _card('NAXIS2', len(tiles)),
        _card('PCOUNT', len(heap)), _card('GCOUNT', 1),
        _card('TFIELDS', 3 if quantize is not None else 1),
        _card('TTYPE1', 'COMPRESSED_DATA', string=True),
        _card('TFORM1', '1PB(%d)' % max(map(len, tiles)), string=True),
    ]
    if quantize is not None:
        cards += [_card('TTYPE2', 'ZSCALE', string=True), _card('TFORM2', '1D', string=True),
                  _card('TTYPE3', 'ZZERO', string=True), _card('TFORM3', '1D', string=True)]
    cards += [
        _card('ZIMAGE', True), _card('ZCMPTYPE', zcmptype, string=True),
        _card('ZBITPIX', zbitpix), _card('ZNAXIS', 2),
        _card('ZNAXIS1', wdt), _card('ZNAXIS2', h),
        _card('ZTILE1', wdt), _card('ZTILE2', tile_rows),
        _card('ZNAME1', 'BLOCKSIZE', string=True), _card('ZVAL1', 32),
        _card('ZNAME2', 'BYTEPIX', string=True), _card('ZVAL2', bytepix),
    ]
    if dither:
        cards += [_card('ZQUANTIZ', dither, string=True), _card('ZDITHER0', zdither0)]
    for k, v in extra_cards:
        cards.append(_card(k, v, string=isinstance(v, str)))
    cards.append(b'END'.ljust(CARD))

    primary = _pad(b''.join([_card('SIMPLE', True), _card('BITPIX', 8),
                             _card('NAXIS', 0), _card('EXTEND', True),
                             b'END'.ljust(CARD)]))
    ext_header = _pad(b''.join(cards))
    data = _pad(bytes(rows) + bytes(heap))
    with open(path, 'wb') as f:
        f.write(primary + ext_header + data)
    return truth


def jsocify(src: str, dst_dir: str) -> str:
    """Re-package a plain FITS as a JSOC-lev1-style tile-compressed file."""
    from sunerf_tpu_torch.data.fits import read_fits
    data, header = read_fits(src)
    skip = {'SIMPLE', 'BITPIX', 'NAXIS', 'NAXIS1', 'NAXIS2', 'EXTEND', 'BSCALE', 'BZERO'}
    extra = [(k, v) for k, v in header.cards.items() if k not in skip]
    extra += [('QUALITY', 0), ('LVL_NUM', 1.5), ('INSTRUME', 'AIA_3'),
              ('ORIGIN', 'SDO/JSOC-SDP')]
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, os.path.basename(src))
    # DITHER_2: the JSOC compress default (exact zeros preserved); zscale
    # from the data range like fpack's qlevel heuristic
    finite = data[np.isfinite(data)]
    q = max(float(np.std(finite)) / 64.0, 1e-12)
    seed = (zlib.crc32(os.path.basename(src).encode()) % 10000) + 1
    write_tile_compressed(dst, data.astype(np.float32), tile_rows=16, quantize=q,
                          dither='SUBTRACTIVE_DITHER_2', zdither0=seed,
                          extra_cards=tuple(extra))
    return dst


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=1500)
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--seed', type=int, default=7)
    parser.add_argument('--workdir', default=None)
    parser.add_argument('--out', default=None)
    parser.add_argument('--device', '--platform', dest='device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)

    from sunerf_tpu_torch.data.fits import read_fits
    from sunerf_tpu_torch.data.loaders import build_single_channel_data
    from sunerf_tpu_torch.data.prep import prep_file
    from sunerf_tpu_torch.evaluation.image_render import render_observers
    from sunerf_tpu_torch.scripts.occupancy_ablation import run_variant
    from sunerf_tpu_torch.scripts.probe_step import launches_by_kernel, zero_counts

    zero_counts()
    workdir = args.workdir or tempfile.mkdtemp(prefix='rehearsal_')

    # 1. synthesize AIA-like observations (2014: degradation-era timestamps)
    observers = [{'name': 'aia', 'lat': 5.0 * ((i % 3) - 1), 'lon': i * 45.0,
                  'distance': 215.0, 'time': datetime(2014, 1, 15).isoformat()}
                 for i in range(8)]
    render_observers({
        'model': 'SimpleStar', 'render_path': os.path.join(workdir, 'renders'),
        'render_format': ['fits'], 'resolution': args.resolution,
        'wavelengths': [193], 'batch_size': 4096,
        'pixel_intensity_factor': 1e9, 'observers': observers}, device=args.device)

    # 2. re-package as JSOC-style compressed lev1 files
    raw_dir = os.path.join(workdir, 'jsoc_raw')
    n = 0
    for f in sorted(glob.glob(os.path.join(workdir, 'renders', 'aia', '193', '*.fits'))):
        jsocify(f, raw_dir)
        n += 1
    print(f'jsocified {n} files (RICE_1 + SUBTRACTIVE_DITHER_2)')

    # 3. prep sdo: decompress, degradation-correct, resample, normalize
    prep_dir = os.path.join(workdir, 'prep')
    n_prep = sum(1 for f in sorted(glob.glob(os.path.join(raw_dir, '*.fits')))
                 if prep_file(f, prep_dir, 'sdo', resolution=args.resolution))
    if n_prep != n:
        raise RuntimeError(f'prep dropped files: {n_prep}/{n}')

    # prep of the compressed file against prep of the original render: the
    # same prep on both isolates the compress / decode error
    first_render = sorted(glob.glob(os.path.join(workdir, 'renders', 'aia', '193',
                                                 '*.fits')))[0]
    ref_prep = prep_file(first_render, os.path.join(workdir, 'prep_ref'), 'sdo',
                         resolution=args.resolution)
    a, _ = read_fits(ref_prep)
    b, _ = read_fits(sorted(glob.glob(os.path.join(prep_dir, '*.fits')))[0])
    if not np.isfinite(b).all():
        raise RuntimeError('NaNs leaked through prep')
    scale = float(np.abs(a).max()) or 1.0
    quant_err = float(np.max(np.abs(a - b))) / scale
    if quant_err >= 5e-3:
        raise RuntimeError(f'compressed prep deviates from uncompressed: rel err '
                           f'{quant_err:.2e}')
    print(f'prep compress/decode rel err {quant_err:.2e} (vs uncompressed)')

    # 4. train + held-out metrics
    data = build_single_channel_data(os.path.join(prep_dir, '*.fits'),
                                     os.path.join(workdir, 'work'), batch_size=1024)
    result = run_variant('rehearsal', data, workdir, args.steps, seed=args.seed,
                         device=args.device, n_stratified=64, n_hierarchical=128)

    out = {'rehearsal': result, 'n_files': n, 'steps': args.steps,
           'pipeline': 'SimpleStar -> JSOC-style RICE+DITHER_2 -> prep sdo '
                       '-> train -> held-out metrics',
           'workdir': workdir}
    print(json.dumps(out))
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(out, fh, indent=2)
    out['quant_err'] = quant_err
    out['launches'] = launches_by_kernel()
    return out


if __name__ == '__main__':
    main()
