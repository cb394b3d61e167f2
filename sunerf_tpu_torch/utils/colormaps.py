"""Native SDO/AIA instrument color tables (reference parity item: the
reference's validation panels and JPEG frames use sunpy's per-wavelength
`sdoaia{wl}` colormaps — train/callback.py:141,228, data/utils.py:25,
evaluation/image_render.py:73 — where this repo previously substituted
matplotlib's `afmhot`).

The tables are computed from the published AIA color-table algorithm (SSW
IDL `aia_lct.pro`: three base ramps c0=linear, c1=sqrt, c2=quadratic, and
the c3 blend, assigned per wavelength to the R/G/B channels) rather than
vendoring sunpy, which is not in this image. STEREO/EUVI and SolO channels
map onto the nearest AIA table exactly as the reference does
(data/utils.py:25: 174 -> sdoaia171). A copy of sunerf_tpu/utils/colormaps.py.
"""
from __future__ import annotations

import numpy as np

_c0 = np.arange(256, dtype=np.float64)
_c1 = np.sqrt(_c0) * np.sqrt(255.0)
_c2 = _c0 ** 2 / 255.0
_c3 = (_c1 + _c2 / 2.0) * 255.0 / (_c1.max() + _c2.max() / 2.0)

# R/G/B ramp assignment per AIA wavelength (aia_lct.pro).
_AIA_RGB = {
    94: (_c2, _c3, _c0),
    131: (_c2, _c1, _c0),
    171: (_c1, _c0, _c2),
    193: (_c1, _c2, _c0),
    211: (_c1, _c0, _c3),
    304: (_c3, _c2, _c0),
    335: (_c2, _c0, _c3),
    1600: (_c3, _c3, _c2),
    1700: (_c1, _c0, _c0),
    4500: (_c0, _c0, _c2 / 2.0),
}

# Non-AIA EUV channels -> nearest AIA table (reference data/utils.py:25
# maps EUVI 174 onto sdoaia171; 195/284/305 follow the same convention).
_NEAREST_AIA = {174: 171, 195: 193, 284: 211, 305: 304}


def aia_color_table(wavelength: int) -> np.ndarray:
    """[256, 3] float RGB table in [0, 1] for an AIA wavelength (or a
    supported non-AIA EUV channel mapped to its nearest AIA table)."""
    wl = int(wavelength)
    wl = _NEAREST_AIA.get(wl, wl)
    if wl not in _AIA_RGB:
        raise KeyError(f'no AIA color table for wavelength {wavelength}')
    r, g, b = _AIA_RGB[wl]
    return np.stack([r, g, b], axis=1) / 255.0


def register_matplotlib() -> bool:
    """Register every table as `sdoaia{wl}` with matplotlib (idempotent).
    Returns False when matplotlib is absent."""
    try:
        import matplotlib
        from matplotlib.colors import ListedColormap
    except Exception:
        return False
    for wl in _AIA_RGB:
        name = f'sdoaia{wl}'
        if name not in matplotlib.colormaps:
            matplotlib.colormaps.register(
                ListedColormap(aia_color_table(wl), name=name))
    return True


def wavelength_cmap(wavelength, default: str = 'afmhot'):
    """Matplotlib colormap (or name) for a channel: the instrument
    `sdoaia{wl}` table when the wavelength is known, else `default`.
    Safe to call without matplotlib (returns `default`)."""
    if wavelength is None:
        return default
    try:
        wl = int(round(float(wavelength)))
    except (TypeError, ValueError):
        return default
    if _NEAREST_AIA.get(wl, wl) not in _AIA_RGB or not register_matplotlib():
        return default
    return f'sdoaia{_NEAREST_AIA.get(wl, wl)}'


def apply_color_table(img01: np.ndarray, wavelength) -> np.ndarray:
    """Pure-numpy LUT application for PIL-only paths (no matplotlib):
    [H, W] floats in [0, 1] -> [H, W, 3] uint8. Unknown wavelength falls
    back to grayscale."""
    idx = (np.clip(np.asarray(img01, np.float64), 0.0, 1.0)
           * 255.0).astype(np.uint8)
    try:
        table = aia_color_table(wavelength) if wavelength is not None else None
    except (KeyError, TypeError, ValueError):
        table = None
    if table is None:
        return np.repeat(idx[..., None], 3, axis=-1)
    return (table[idx] * 255.0).astype(np.uint8)
