"""Synthetic-observation generator: render EUV filtergrams of the analytic
SimpleStar or of PSI MHD cubes through the DT radiative-transfer head and
write FITS/JPEG frames (sunerf_tpu/evaluation/image_render.py; reference
evaluation/image_render.py:20-297 with config/render_mhd.yaml). This is how
SimpleStar training sets are made.

Usage:
  python -m sunerf_tpu_torch.evaluation.image_render --config config/render_simple_star.yaml
         [--device cuda|cpu]

Config keys (the JAX CLI's):
  model: SimpleStar | MHDModel
  data_path: (MHDModel only) directory with rho/ and t/ HDF5 frames, read
    without h5py (data/psi_io.py)
  render_path: output directory, written as <name>/<wavelength>/*.fits|jpg
  render_format: [jpeg, fits]
  batch_size: rays per device batch
  resolution: image size
  wavelengths: channels to render
  pixel_intensity_factor: output scale (1e10)
  zero_absorption: transparent corona on both passes (default true)
  observers: list of {lat, lon, distance, time} (degrees / solar radii /
    ISO datetime or float), or observer_names + observer_dir to copy the
    observer geometry from FITS directories.
Frames are written as the JAX package writes them: row 0 is the render's
first row (observer_rays' top), which the FITS loader reads as the bottom
of the WCS (ROADMAP Queue 3, recorded properties).
"""
from __future__ import annotations

import argparse
import glob
import os
from datetime import datetime, timedelta

import numpy as np

from sunerf_tpu_torch.data.fits import read_fits, write_fits
from sunerf_tpu_torch.data.wcs import observer_header, parse_observer
from sunerf_tpu_torch.evaluation.loader import ModelLoader
from sunerf_tpu_torch.models.fields import AIA_WAVELENGTHS


def build_model_renderer(config: dict, device='cuda'):
    """(renderer, params) of config['model'] on `device`, no sampling
    jitter."""
    name = config.get('model', 'SimpleStar')
    # PyYAML parses '1.0e9' (no sign) as a string: coerce
    pif = float(config.get('pixel_intensity_factor', 1e10))
    if name == 'SimpleStar':
        from sunerf_tpu_torch.systems import make_simple_star_renderer
        renderer, init = make_simple_star_renderer(
            pixel_intensity_factor=pif, perturb=False, device=device)
        params = init()
    elif name == 'MHDModel':
        from sunerf_tpu_torch.models.mhd_field import MHDFieldLoader
        from sunerf_tpu_torch.systems import make_mhd_renderer
        renderer, params = make_mhd_renderer(
            MHDFieldLoader(config['data_path'], device=device),
            pixel_intensity_factor=pif, perturb=False)
    else:
        raise ValueError(f'unknown model {name!r}')
    if config.get('zero_absorption', True):
        # the reference's log_abs tables (~20 per channel) render black
        # frames (kappa = rho * 20 is fully opaque at rho ~ 1e5-1e8): a
        # transparent corona by default, set on BOTH passes (the image comes
        # from the fine pass; the two passes share one dict only by init)
        import torch
        zeros = torch.zeros(len(AIA_WAVELENGTHS), device=device)
        params = {'coarse': dict(params['coarse'], log_abs=zeros),
                  'fine': dict(params['fine'], log_abs=zeros)}
    return renderer, params


def observers_from_config(config: dict) -> list[dict]:
    if 'observers' in config:
        obs = []
        for o in config['observers']:
            t = o.get('time', 0.0)
            if isinstance(t, str):
                t = datetime.fromisoformat(t)
            obs.append({'lat': float(o['lat']), 'lon': float(o['lon']),
                        'distance': float(o.get('distance', 215.0)),
                        'time': t, 'name': o.get('name', 'obs')})
        return obs
    observers = []
    for name, d in zip(config.get('observer_names', []),
                       config.get('observer_dir', [])):
        for f in sorted(glob.glob(os.path.join(d, '*.fits'))):
            _, header = read_fits(f)
            o = parse_observer(header)
            observers.append({'lat': np.rad2deg(o.carrington_lat),
                              'lon': np.rad2deg(o.carrington_lon),
                              'distance': o.dsun_rs, 'time': o.time,
                              'name': name})
    return observers


def frame_to_jpeg(path: str, image: np.ndarray, wavelength=None):
    """Asinh-normalized JPEG (reference frame_to_jpeg, image_render.py:38-91),
    through the channel's AIA color table when a wavelength is given.
    Without PIL it writes nothing."""
    try:
        from PIL import Image
    except ImportError:
        return
    from sunerf_tpu_torch.utils.colormaps import apply_color_table
    img = np.asarray(image, np.float64)
    img = np.arcsinh(img / (0.005 * (img.max() or 1.0)))
    img = img / (img.max() or 1.0)
    if wavelength is not None:
        Image.fromarray(apply_color_table(img, wavelength)).save(path)
        return
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def render_observers(config: dict, device='cuda') -> list[str]:
    """Render every observer at every wavelength and write the frames;
    returns their paths without extension."""
    renderer, params = build_model_renderer(config, device)
    resolution = config.get('resolution', 256)
    wavelengths = config.get('wavelengths', list(AIA_WAVELENGTHS))
    render_path = config['render_path']
    formats = config.get('render_format', ['jpeg'])
    overwrite = config.get('overwrite', True)
    seconds_per_dt = config.get('seconds_per_dt', 86400.0)

    observers = observers_from_config(config)
    ref_times = [o['time'] for o in observers if isinstance(o['time'], datetime)]
    loader = ModelLoader(renderer, params,
                         ref_time=min(ref_times) if ref_times else None,
                         seconds_per_dt=seconds_per_dt,
                         batch_size=config.get('batch_size', 4096), device=device)

    outputs = []
    for i, obs in enumerate(observers):
        view = loader.render_observer_image(
            lat=np.deg2rad(obs['lat']), lon=np.deg2rad(obs['lon']),
            time=obs['time'], distance=obs['distance'],
            resolution=resolution, wavelengths=wavelengths)
        # float times map onto a synthetic epoch so FITS headers carry a real
        # DATE-OBS that round-trips through the training loaders
        if isinstance(obs['time'], datetime):
            header_time = obs['time']
        else:
            header_time = datetime(2000, 1, 1) + timedelta(
                seconds=float(obs['time']) * seconds_per_dt)
        tstr = header_time.strftime('%Y-%m-%dT%H:%M:%S')
        for c, wl in enumerate(wavelengths):
            out_dir = os.path.join(render_path, obs['name'], str(int(wl)))
            os.makedirs(out_dir, exist_ok=True)
            # the observer index keeps views that share name and time apart
            base = os.path.join(out_dir, f"{obs['name']}_{i:03d}.{tstr}.{int(wl)}")
            if 'fits' in formats:
                header = observer_header(obs['lat'], obs['lon'], obs['distance'],
                                         header_time, resolution, float(wl))
                if overwrite or not os.path.exists(base + '.fits'):
                    write_fits(base + '.fits', view.image[:, :, c], header)
            if 'jpeg' in formats:
                frame_to_jpeg(base + '.jpg', view.image[:, :, c], wavelength=wl)
            outputs.append(base)
    return outputs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)
    import yaml
    with open(args.config) as f:
        config = yaml.safe_load(f)
    outputs = render_observers(config, device=args.device)
    print(f'rendered {len(outputs)} frames -> {config["render_path"]}')


if __name__ == '__main__':
    main()
