"""Training-time visualization: pose overview and ray-sampling diagnostics
(reference sunerf/train/callback.py:180-256: log_overview 3-D quiver of all
camera poses; plot_ray_sampling). A copy of sunerf_tpu/train/visualization.py.
matplotlib is imported only when a plot is drawn; without it the plot
functions raise ImportError, which the Trainer logs and goes on."""
from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def log_overview(images, poses, times, path: str, cmap: str = 'afmhot',
                 wavelength=None):
    """3-D quiver of all camera poses colored by time + a strip of sample
    images (reference callback.py:180-234). With a wavelength, sample
    images use the instrument colormap (reference callback.py:228)."""
    plt = _mpl()
    if wavelength is not None:
        from sunerf_tpu_torch.utils.colormaps import wavelength_cmap
        cmap = wavelength_cmap(wavelength, default=cmap)
    poses = np.asarray(poses)
    origins = poses[:, :3, 3]
    norms = np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs = -origins / np.maximum(norms, 1e-12)

    fig = plt.figure(figsize=(12, 6))
    ax = fig.add_subplot(1, 2, 1, projection='3d')
    t = np.asarray(times, float)
    norm_t = (t - t.min()) / (np.ptp(t) or 1.0)
    ax.quiver(origins[:, 0], origins[:, 1], origins[:, 2],
              dirs[:, 0], dirs[:, 1], dirs[:, 2],
              length=np.linalg.norm(origins, axis=-1).mean() * 0.3)
    ax.scatter(origins[:, 0], origins[:, 1], origins[:, 2], c=norm_t,
               cmap='viridis')
    ax.set_title('camera poses (color = time)')

    n_show = min(4, len(images))
    for i in range(n_show):
        axi = fig.add_subplot(2, 4, 3 + i + (i // 2) * 2)
        img = np.asarray(images[i])
        if img.ndim == 3:
            img = img[..., 0]
        axi.imshow(np.arcsinh(img / 0.005), cmap=cmap, origin='lower')
        axi.axis('off')
    fig.savefig(path, dpi=100, bbox_inches='tight')
    plt.close(fig)
    return path


def plot_ray_sampling(z_stratified, z_hierarchical, path: str, n_rays: int = 32):
    """Scatter of stratified vs hierarchical sample positions along example
    rays (reference callback.py:237-256)."""
    plt = _mpl()
    zs = np.asarray(z_stratified)[:n_rays]
    zh = np.asarray(z_hierarchical)[:n_rays]
    fig, ax = plt.subplots(figsize=(9, 4))
    # zs and zh may have different ray counts (tiered training returns the
    # bright tier's hierarchical samples only) — plot each independently
    for i in range(zs.shape[0]):
        ax.scatter(zs[i], np.full(zs.shape[1], i), s=2, c='tab:blue')
    for i in range(zh.shape[0]):
        ax.scatter(zh[i], np.full(zh.shape[1], i), s=2, c='tab:red')
    ax.set_xlabel('distance along ray')
    ax.set_ylabel('ray index')
    ax.set_title('stratified (blue) vs hierarchical (red) samples')
    fig.savefig(path, dpi=100, bbox_inches='tight')
    plt.close(fig)
    return path
