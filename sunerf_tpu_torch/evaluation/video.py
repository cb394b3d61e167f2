"""Flyby video frames from a trained SuNeRF bundle: ecliptic orbit + polar
pass + zoom, saved as JPEG frames (sunerf_tpu/evaluation/video.py; ffmpeg
assembly of the frames stays manual).

Usage: python -m sunerf_tpu_torch.evaluation.video --state <bundle> \
           --output frames/ [--n-frames 60] [--resolution 256] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from sunerf_tpu_torch.core.geometry import fov_for_distance
from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader


def frame_to_jpeg(path: str, image: np.ndarray):
    """Asinh-normalized greyscale JPEG (the grey branch of
    sunerf_tpu/evaluation/image_render.py:frame_to_jpeg). Writes nothing when
    PIL is missing."""
    try:
        from PIL import Image
    except ImportError:
        return
    img = np.asarray(image, np.float64)
    img = np.arcsinh(img / (0.005 * (img.max() or 1.0)))
    img = img / (img.max() or 1.0)
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def flyby_poses(n_frames: int = 60, distance: float = 215.0):
    """(lat, lon, distance) path: ecliptic orbit -> polar arc -> zoom."""
    third = n_frames // 3
    poses = []
    for lon in np.linspace(0, 2 * np.pi, third, endpoint=False):
        poses.append((0.0, lon, distance))
    for lat in np.linspace(0, np.pi / 3, third):
        poses.append((lat, 0.0, distance))
    for d in np.linspace(distance, distance / 2, n_frames - 2 * third):
        poses.append((np.pi / 3, 0.0, d))
    return poses


def render_video_frames(state_path: str, output_dir: str, n_frames: int = 60,
                        resolution: int = 256, time: float = 0.0,
                        batch_size: int = 4096, wavelengths=None,
                        distance: float = 215.0, device='cuda'):
    """Render the flyby of a deployment bundle into output_dir; returns the
    frame paths."""
    if state_path.endswith('.shlo'):
        raise NotImplementedError('serving artifacts (.shlo) are not ported '
                                  'yet (ROADMAP Queue 1, serving export); '
                                  'pass the deployment bundle')
    loader = SuNeRFLoader(state_path, batch_size=batch_size, device=device)
    if wavelengths is None:
        wl_cfg = loader.wavelengths
        wavelengths = list(wl_cfg) if wl_cfg else None
    os.makedirs(output_dir, exist_ok=True)
    # pin the FOV at the orbit distance, so the zoom leg zooms
    fov = fov_for_distance(distance)
    paths = []
    for i, (lat, lon, dist) in enumerate(flyby_poses(n_frames, distance)):
        view = loader.render_observer_image(
            lat=lat, lon=lon, time=time, distance=dist,
            resolution=resolution, wavelengths=wavelengths, fov=fov)
        path = os.path.join(output_dir, f'frame_{i:04d}.jpg')
        frame_to_jpeg(path, view.image[:, :, 0])
        paths.append(path)
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--state', required=True)
    parser.add_argument('--output', required=True)
    parser.add_argument('--n-frames', type=int, default=60)
    parser.add_argument('--resolution', type=int, default=256)
    parser.add_argument('--time', type=float, default=0.0)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    paths = render_video_frames(args.state, args.output, args.n_frames,
                                args.resolution, args.time, device=args.device)
    print(f'wrote {len(paths)} frames to {args.output} '
          f'(assemble: ffmpeg -i frame_%04d.jpg video.mp4)')


if __name__ == '__main__':
    main()
