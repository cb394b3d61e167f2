"""Data acquisition CLIs: fetch SDO/AIA, STEREO/EUVI, SolO/EUI FITS files
(sunerf_tpu/data/download.py; the port imports nothing of the JAX package).

Native port of the reference download scripts (sunerf/data/download/:
sdo_jsoc.py JSOC/drms export, helio_concurrent_aia_stereo.py Fido AIA+EUVI,
solo_eui.py, synoptic_map.py). These genuinely require the external `drms` /
`sunpy` packages and network access — both are optional here: each subcommand
checks for its dependency and explains what to install if missing. The query
logic itself is complete.

Usage:
  python -m sunerf_tpu_torch.data.download jsoc  --email you@x --start 2012-08-01 \
      --end 2012-09-01 --wavelengths 171 193 --cadence 6h --out raw/sdo
  python -m sunerf_tpu_torch.data.download fido  --start 2012-08-01 --end 2012-09-01 \
      --wavelength 195 --source STEREO_A --out raw/stereo
  python -m sunerf_tpu_torch.data.download eui   --start 2022-03-01 --end 2022-03-05 \
      --out raw/solo
"""
from __future__ import annotations

import argparse
import os


def download_jsoc(email: str, start: str, end: str, wavelengths, cadence: str,
                  out_dir: str, series: str = 'aia.lev1_euv_12s'):
    """JSOC export of AIA EUV level-1 images (reference sdo_jsoc.py:41-115)."""
    try:
        import drms
    except ImportError as e:
        raise ImportError(
            'JSOC download requires the `drms` package (pip install drms); '
            'this host ships without it — run on a data-prep host') from e
    client = drms.Client(email=email)
    os.makedirs(out_dir, exist_ok=True)
    downloaded = []
    for wl in wavelengths:
        query = f'{series}[{start}Z-{end}Z@{cadence}][{wl}]{{image}}'
        result = client.export(query, method='url', protocol='fits')
        result.wait()
        wl_dir = os.path.join(out_dir, str(wl))
        os.makedirs(wl_dir, exist_ok=True)
        downloaded += list(result.download(wl_dir).download.values)
    return downloaded


def download_fido(start: str, end: str, wavelength: int, source: str,
                  out_dir: str, sample_hours: float = 6.0):
    """VSO search+fetch for AIA or SECCHI/EUVI (reference
    helio_concurrent_aia_stereo.py:59-133)."""
    try:
        import astropy.units as u
        from sunpy.net import Fido, attrs as a
    except ImportError as e:
        raise ImportError(
            'Fido download requires `sunpy[net]`; this host ships '
            'without it — run on a data-prep host') from e
    os.makedirs(out_dir, exist_ok=True)
    query = [a.Time(start, end), a.Wavelength(wavelength * u.AA),
             a.Sample(sample_hours * u.hour)]
    if source.upper().startswith('STEREO'):
        query += [a.Source(source.upper()), a.Instrument('SECCHI'),
                  a.Detector('EUVI')]
    else:
        query += [a.Instrument('AIA')]
    result = Fido.search(*query)
    return Fido.fetch(result, path=os.path.join(out_dir, '{file}'))


def download_eui(start: str, end: str, out_dir: str,
                 product: str = 'EUI-FSI174-IMAGE'):
    """Solar Orbiter EUI FSI fetch (reference solo_eui.py:12-23)."""
    try:
        import astropy.units as u  # noqa: F401
        from sunpy.net import Fido, attrs as a
    except ImportError as e:
        raise ImportError(
            'EUI download requires `sunpy[net]` + `sunpy-soar`; this host '
            'ships without them — run on a data-prep host') from e
    os.makedirs(out_dir, exist_ok=True)
    result = Fido.search(a.Time(start, end), a.Instrument('EUI'),
                         a.Level(2), a.soar.Product(product))
    return Fido.fetch(result, path=os.path.join(out_dir, '{file}'))


def download_synoptic(carrington_rotation: int, out_dir: str,
                      series: str = 'hmi.synoptic_mr_polfil_720s'):
    """Synoptic-map fetch with header fixes (reference
    data/download/synoptic_map.py:22-75)."""
    try:
        import drms
    except ImportError as e:
        raise ImportError(
            'synoptic download requires the `drms` package; run on a '
            'data-prep host') from e
    client = drms.Client()
    os.makedirs(out_dir, exist_ok=True)
    seg = client.query(f'{series}[{carrington_rotation}]', seg='Mr_polfil')
    urls = ['http://jsoc.stanford.edu' + u for u in seg.Mr_polfil]
    import urllib.request
    paths = []
    for url in urls:
        dst = os.path.join(out_dir, os.path.basename(url))
        urllib.request.urlretrieve(url, dst)
        paths.append(dst)
    return paths


STEREO_WAVELENGTHS = ('171', '195', '284', '304')
SDO_TARGET_WAVELENGTHS = (171, 193, 211, 304)


def align_stereo_basenames(data_path: str, out_dir: str | None = None,
                           wavelengths=STEREO_WAVELENGTHS) -> list[str]:
    """Basenames present in ALL wavelength subdirectories of data_path (the
    reference's time alignment, convert_stereo_to_sdo.py:22-29), minus ones
    already converted into out_dir."""
    import glob as _glob
    per_wl = [{os.path.basename(f)
               for f in _glob.glob(os.path.join(data_path, wl, '*.fits'))}
              for wl in wavelengths]
    names = sorted(set.intersection(*per_wl)) if per_wl else []
    if out_dir:
        existing = {os.path.basename(f) for f in _glob.glob(
            os.path.join(out_dir, str(wavelengths[0]), '*.fits'))}
        names = [n for n in names if n not in existing]
    return names


def _build_iti_translator(model_name: str, resolution: int):
    """The GAN translator over the published stereo_to_sdo_v0_2.pt model —
    the reference's STEREOToSDO subclass (convert_stereo_to_sdo.py:84-108):
    SECCHI prep editors per channel, model inference, per-channel AIA norm
    inversion, AIA-like metadata. Requires the external `iti` package + sunpy
    (GPU data-prep host)."""
    try:
        from iti.data.dataset import BaseDataset, StackDataset
        from iti.data.editor import (ExpandDimsEditor, LoadMapEditor,
                                     MapToDataEditor, NormalizeEditor,
                                     NormalizeRadiusEditor, SECCHIPrepEditor,
                                     sdo_norms, stereo_norms)
        from iti.translate import InstrumentToInstrument
        from sunpy.map import Map
    except ImportError as e:
        raise ImportError(
            'STEREO->SDO conversion requires the external `iti` package '
            '(instrument-to-instrument GAN) and sunpy — run on a GPU '
            'data-prep host') from e

    class _SECCHIDataset(BaseDataset):
        def __init__(self, data, wavelength, degradation=None, **kwargs):
            editors = [LoadMapEditor(),
                       SECCHIPrepEditor(degradation),
                       NormalizeRadiusEditor(resolution, crop=False),
                       MapToDataEditor(),
                       NormalizeEditor(stereo_norms[wavelength]),
                       ExpandDimsEditor()]
            super().__init__(data, editors=editors, **kwargs)

    class _STEREODataset(StackDataset):
        def __init__(self, paths, **kwargs):
            # 304 degradation polynomial from the reference
            # (convert_stereo_to_sdo.py:77)
            data_sets = [
                _SECCHIDataset(paths[0], 171),
                _SECCHIDataset(paths[1], 195),
                _SECCHIDataset(paths[2], 284),
                _SECCHIDataset(paths[3], 304,
                               degradation=[-9.42497209e-05, 2.27153104e+00]),
            ]
            super().__init__(data_sets, **kwargs)

    class _Translator(InstrumentToInstrument):
        def translate(self, paths, basenames=None):
            dataset = _STEREODataset(paths, basenames=basenames)
            norms = [sdo_norms[wl] for wl in SDO_TARGET_WAVELENGTHS]
            for result, _, _ in self._translateDataset(dataset):
                yield [Map(norm.inverse((s_map.data + 1) / 2),
                           self._to_sdo_meta(s_map.meta, wl))
                       for s_map, norm, wl in
                       zip(result, norms, SDO_TARGET_WAVELENGTHS)]

        def _to_sdo_meta(self, meta, wl):
            new_meta = meta.copy()
            new_meta['obsrvtry'] = 'STEREO-to-SDO'
            new_meta['telescop'] = 'sdo'
            new_meta['instrume'] = 'AIA'
            new_meta['WAVELNTH'] = wl
            new_meta['waveunit'] = 'angstrom'
            return new_meta

    return _Translator(model_name)


def convert_stereo_to_sdo(data_path: str, out_dir: str,
                          model_name: str = 'stereo_to_sdo_v0_2.pt',
                          resolution: int = 1024,
                          translator=None) -> list[str]:
    """ITI GAN instrument conversion SECCHI -> AIA-like FITS (reference
    data/euv/convert_stereo_to_sdo.py:52-128, time-aligned 4-wavelength
    variant _full.py:30-42).

    data_path holds 171/195/284/304 subdirectories of prepped SECCHI FITS;
    each basename present in all four is translated to AIA-like 171/193/211/
    304 maps written to out_dir/<wl>/<basename>. Already-converted basenames
    are skipped (resumable). `translator` injects a prebuilt/fake translator
    (tests); default builds the ITI GAN."""
    basenames = align_stereo_basenames(data_path, out_dir)
    if not basenames:
        return []
    if translator is None:
        translator = _build_iti_translator(model_name, resolution)

    for wl in SDO_TARGET_WAVELENGTHS:
        os.makedirs(os.path.join(out_dir, str(wl)), exist_ok=True)
    paths = [[os.path.join(data_path, wl, b) for b in basenames]
             for wl in STEREO_WAVELENGTHS]

    written = []
    for maps, basename in zip(translator.translate(paths, basenames=basenames),
                              basenames):
        for s_map, wl in zip(maps, SDO_TARGET_WAVELENGTHS):
            path = os.path.join(out_dir, str(wl), basename)
            if not os.path.exists(path):
                s_map.save(path)
                written.append(path)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest='cmd', required=True)

    p = sub.add_parser('jsoc')
    p.add_argument('--email', required=True)
    p.add_argument('--start', required=True)
    p.add_argument('--end', required=True)
    p.add_argument('--wavelengths', nargs='+', type=int, default=[171, 193])
    p.add_argument('--cadence', default='6h')
    p.add_argument('--out', required=True)

    p = sub.add_parser('fido')
    p.add_argument('--start', required=True)
    p.add_argument('--end', required=True)
    p.add_argument('--wavelength', type=int, required=True)
    p.add_argument('--source', default='AIA')
    p.add_argument('--out', required=True)
    p.add_argument('--sample-hours', type=float, default=6.0)

    p = sub.add_parser('eui')
    p.add_argument('--start', required=True)
    p.add_argument('--end', required=True)
    p.add_argument('--out', required=True)

    p = sub.add_parser('synoptic')
    p.add_argument('--carrington-rotation', type=int, required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--series', default='hmi.synoptic_mr_polfil_720s')

    p = sub.add_parser('stereo-to-sdo')
    p.add_argument('--data-path', required=True,
                   help='directory with 171/195/284/304 prepped SECCHI FITS')
    p.add_argument('--out', required=True)
    p.add_argument('--model', default='stereo_to_sdo_v0_2.pt')
    p.add_argument('--resolution', type=int, default=1024)

    args = parser.parse_args(argv)
    if args.cmd == 'jsoc':
        files = download_jsoc(args.email, args.start, args.end,
                              args.wavelengths, args.cadence, args.out)
    elif args.cmd == 'fido':
        files = download_fido(args.start, args.end, args.wavelength,
                              args.source, args.out, args.sample_hours)
    elif args.cmd == 'synoptic':
        files = [download_synoptic(args.carrington_rotation, args.out,
                                   args.series)]
    elif args.cmd == 'stereo-to-sdo':
        files = convert_stereo_to_sdo(args.data_path, args.out,
                                      model_name=args.model,
                                      resolution=args.resolution)
    else:
        files = download_eui(args.start, args.end, args.out)
    print(f'downloaded {len(files)} files')


if __name__ == '__main__':
    main()
