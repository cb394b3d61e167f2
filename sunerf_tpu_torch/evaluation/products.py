"""Scientific data products from a trained SuNeRF
(sunerf_tpu/evaluation/products.py): voxel volume extraction, synchronic
full-surface maps, topographic height/absorption maps, eruption time
profiles, and a coarse-vs-fine uncertainty proxy (the reference's stash
scripts, sunerf/evaluation/stash/).

Every product goes through the loader's public methods: load_coords for the
volume, render_observer_image for the views, render_rays for the radial
rays of the synchronic map and for the uncertainty map's coarse and fine
images (the JAX package's products reach its loader's private _render and
renderer). On the card the fields run K0.

Usage: python -m sunerf_tpu_torch.evaluation.products <product> --state <bundle> \\
           --output out.npz [--resolution 128] [--device cuda]
"""
from __future__ import annotations

import numpy as np

from sunerf_tpu_torch.baseline.reprojection import carrington_to_world
from sunerf_tpu_torch.core.geometry import observer_rays
from sunerf_tpu_torch.evaluation.loader import ModelLoader


def main(argv=None):
    """CLI: python -m sunerf_tpu_torch.evaluation.products <product> --state ...

    Products: volume | synchronic | topographic | eruption | uncertainty.
    Writes the product's arrays as one .npz."""
    import argparse

    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.evaluation.serving import ServingModel, is_artifact

    parser = argparse.ArgumentParser()
    parser.add_argument('product', choices=['volume', 'synchronic',
                                            'topographic', 'eruption',
                                            'uncertainty'])
    parser.add_argument('--state', required=True)
    parser.add_argument('--output', required=True, help='output .npz path')
    parser.add_argument('--time', type=float, default=0.0)
    parser.add_argument('--lat', type=float, default=0.0, help='degrees')
    parser.add_argument('--lon', type=float, default=0.0, help='degrees')
    parser.add_argument('--distance', type=float, default=215.0)
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--times', type=float, nargs='+', default=None)
    parser.add_argument('--wavelengths', type=float, nargs='+', default=None)
    parser.add_argument('--batch-size', type=int, default=4096)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)

    if is_artifact(args.state):
        # a serving artifact: the products built from render_observer_image
        # and load_coords; synchronic and uncertainty need the live
        # renderer's rays and passes (render_rays)
        if args.product in ('synchronic', 'uncertainty'):
            parser.error(f'{args.product} needs the live renderer (render_rays); pass the '
                         'save_state bundle instead of the .tsrv artifact')
        loader = ServingModel(args.state, device=args.device)
    else:
        loader = SuNeRFLoader(args.state, batch_size=args.batch_size, device=args.device)
    lat, lon = np.deg2rad(args.lat), np.deg2rad(args.lon)
    wl = args.wavelengths

    if args.product == 'volume':
        out = extract_volume(loader, args.time, resolution=args.resolution)
    elif args.product == 'synchronic':
        out = {'map': synchronic_map(loader, args.time,
                                     resolution_lat=args.resolution,
                                     wavelengths=wl)}
    elif args.product == 'topographic':
        out = topographic_maps(loader, lat, lon, args.time, args.distance,
                               resolution=args.resolution, wavelengths=wl)
    elif args.product == 'eruption':
        out = eruption_profile(loader, args.times or [0.0, 0.5, 1.0], lat,
                               lon, args.distance,
                               resolution=args.resolution, wavelengths=wl)
    else:
        out = {'uncertainty': uncertainty_map(loader, lat, lon, args.time,
                                              args.distance,
                                              resolution=args.resolution,
                                              wavelengths=wl)}
    np.savez(args.output, **{k: np.asarray(v) for k, v in out.items()})
    print(f'{args.product} -> {args.output}.npz'
          if not args.output.endswith('.npz') else
          f'{args.product} -> {args.output}')


def extract_volume(loader: ModelLoader, time, resolution: int = 64,
                   extent: float = 1.3) -> dict:
    """Query the fine field on a regular [res, res, res] grid spanning
    +/- extent solar radii (reference stash/voxel_volume.py).

    Returns dict(grid=[res] axis coords, raw=[res, res, res, d_out]).
    For DT models raw = (log rho, log10 T); for emission (log eps, kappa).
    """
    axis = np.linspace(-extent, extent, resolution, dtype=np.float32)
    x, y, z = np.meshgrid(axis, axis, axis, indexing='ij')
    t = np.full_like(x, loader.normalize_time(time))
    pts = np.stack([x, y, z, t], axis=-1).reshape(-1, 4)
    raw = loader.load_coords(pts)
    return {'grid': axis, 'raw': raw.reshape(resolution, resolution,
                                             resolution, -1)}


def synchronic_map(loader: ModelLoader, time, resolution_lat: int = 90,
                   height: float = 2.5, wavelengths=None) -> np.ndarray:
    """Full-surface synchronic map at one instant: one radial ray per
    heliographic (lat, lon) cell, integrated from `height` Rsun down to the
    surface.

    Returns [res_lat, 2*res_lat, C] intensity map (plate carree).
    """
    res_lat, res_lon = resolution_lat, 2 * resolution_lat
    lon = (np.arange(res_lon) + 0.5) / res_lon * 2 * np.pi
    lat = (np.arange(res_lat) + 0.5) / res_lat * np.pi - np.pi / 2
    lon_g, lat_g = np.meshgrid(lon, lat)
    surface_dir = carrington_to_world(lat_g, lon_g).reshape(-1, 3)

    rays_o = (surface_dir * height).astype(np.float32)
    rays_d = (-surface_dir).astype(np.float32)
    out = loader.render_rays(rays_o, rays_d, loader.normalize_time(time),
                             wavelengths, keys=('image',), pad_direction=1.0)
    return out['image'].reshape(res_lat, res_lon, -1)


def topographic_maps(loader: ModelLoader, lat: float, lon: float, time,
                     distance: float, resolution: int = 256,
                     wavelengths=None) -> dict:
    """Emission-height and absorption maps for one viewpoint (reference
    stash/topographical_*.py): the renderer's weighted mean sample distance
    and summed transmission."""
    view = loader.render_observer_image(lat=lat, lon=lon, time=time,
                                        distance=distance,
                                        resolution=resolution,
                                        wavelengths=wavelengths)
    return {'height_map': view.height_map,
            'absorption_map': view.absorption_map,
            'image': view.image}


def eruption_profile(loader: ModelLoader, times, lat: float, lon: float,
                     distance: float, resolution: int = 64,
                     wavelengths=None) -> dict:
    """Light curve + per-frame images over a time sequence from a fixed
    viewpoint (reference stash/eruption*.py)."""
    images = []
    for t in times:
        view = loader.render_observer_image(lat=lat, lon=lon, time=t,
                                            distance=distance,
                                            resolution=resolution,
                                            wavelengths=wavelengths)
        images.append(view.image)
    images = np.stack(images)  # [T, H, W, C]
    return {'times': list(times),
            'light_curve': images.sum(axis=(1, 2)),
            'images': images}


def uncertainty_map(loader: ModelLoader, lat: float, lon: float, time,
                    distance: float, resolution: int = 128,
                    wavelengths=None) -> np.ndarray:
    """Coarse-vs-fine discrepancy as a per-pixel uncertainty proxy: the
    channel mean of |coarse image - fine image| (the stash correlates it
    against reconstruction error). The rays are observer_rays' at its
    default field of view, as in the JAX package."""
    rays_o, rays_d = observer_rays(lat, lon, distance, resolution)
    out = loader.render_rays(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                             loader.normalize_time(time), wavelengths,
                             keys=('coarse_image', 'fine_image'), pad_direction=1.0)
    diff = np.abs(out['coarse_image'] - out['fine_image']).mean(axis=-1)
    return diff.reshape(resolution, resolution)


if __name__ == '__main__':
    main()
