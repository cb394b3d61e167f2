"""FITS -> pre-shuffled ray-shard builders of the emission and DT heads
(sunerf_tpu/data/loaders.py; the port imports nothing of the JAX package).

  * build_single_channel_data  <- SingleChannelDataModule (single_channel.py:14-88)
  * build_multi_thermal_data   <- MultiThermalDataModule (multi_thermal_loader.py)

Pipeline per map: FITS -> observer pose (pose_spherical of Carrington lon/lat
+ dsun) -> per-pixel helioprojective rays -> flatten -> global shuffle ->
npy shards on disk consumed by MmapDataset. The same numpy code as the JAX
package's, so the same files give the same arrays and the same batch order.

FITS loading fans out over worker processes (n_workers > 1). They are
spawned, not forked (the parent may hold threads or a CUDA context), and
run with the default SIGTERM disposition whatever handler the parent has
installed (a Trainer's fit installs one while it runs), so a pool's
terminate() always ends them.

Host-side, pure numpy; the device path never touches FITS or WCS.
"""
from __future__ import annotations

import glob
import logging
import os
import re
import signal
from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

import numpy as np

from sunerf_tpu_torch.core.geometry import get_rays, pose_spherical
from sunerf_tpu_torch.core.scaling import normalize_datetime
from sunerf_tpu_torch.data.datasets import ArrayDataset, MmapDataset
from sunerf_tpu_torch.data.fits import read_fits
from sunerf_tpu_torch.data.norms import block_reduce_mean, remove_nans
from sunerf_tpu_torch.data.wcs import helioprojective_grid, parse_observer

logger = logging.getLogger(__name__)


@dataclass
class RayData:
    """Container for the prepared ray bundles of one head."""
    train: MmapDataset
    valid: ArrayDataset
    config: dict
    ref_time: datetime
    Rs_per_ds: float = 1.0
    seconds_per_dt: float = 86400.0
    validation_shape: tuple = ()
    extras: dict = field(default_factory=dict)

    def clear(self):
        self.train.clear()


def load_map_data(path: str, Rs_per_ds: float = 1.0) -> dict:
    """One FITS map -> image + pose + flattened rays + observation time
    (reference base_loader.py:87-103)."""
    data, header = read_fits(path)
    obs = parse_observer(header)
    pose = pose_spherical(-obs.carrington_lon, obs.carrington_lat,
                          obs.dsun_rs / Rs_per_ds)
    tx, ty = helioprojective_grid(header, shape=data.shape)
    rays_o, rays_d = get_rays(tx, ty, pose)
    all_rays = np.stack([rays_o, rays_d], axis=-2).reshape(-1, 2, 3)
    return {'image': data.astype(np.float32), 'pose': pose,
            'all_rays': all_rays, 'time': obs.time,
            'wavelength': obs.wavelength, 'header': header}


def load_map_stack(file_paths: list[str], resolution: Optional[int] = None,
                   remove_nan: bool = True, apply_norm: bool = False,
                   norms: Optional[dict] = None,
                   percentile_clip_percent: Optional[float] = None) -> np.ndarray:
    """Load + optionally resample/normalize a list of FITS files into a
    [C, H, W] stack (reference loadMapStack, data/utils.py:74-125)."""
    from sunerf_tpu_torch.data.norms import SDO_NORMS
    from sunerf_tpu_torch.data.norms import normalize as norm_fn
    from sunerf_tpu_torch.data.norms import percentile_clip as pclip
    norms = norms or SDO_NORMS
    imgs = []
    for p in file_paths:
        data, header = read_fits(p)
        if resolution and data.shape != (resolution, resolution):
            from sunerf_tpu_torch.data.prep import resample
            data, header = resample(data, header, resolution)
        if apply_norm:
            wl = header.get('WAVELNTH')
            wl = int(wl) if wl is not None else None
            if wl in norms:
                data = norm_fn(data, norms[wl])
        imgs.append(data.astype(np.float32))
    stack = np.stack(imgs)
    if remove_nan:
        stack = remove_nans(stack)
    if percentile_clip_percent:
        stack = pclip(stack, percentile_clip_percent)
    return stack


def _save_shards(working_dir: str, arrays: dict) -> dict:
    os.makedirs(working_dir, exist_ok=True)
    paths = {}
    for name, arr in arrays.items():
        p = os.path.join(working_dir, f'{name}_batches.npy')
        np.save(p, arr)
        paths[p_key(name)] = p
    return paths


def p_key(name: str) -> str:
    return {'rays': 'rays', 'times': 'time', 'images': 'target_image',
            'wavelengths': 'wavelength'}[name]


def _default_sigterm():
    """Pool worker initializer: the default SIGTERM disposition, so that
    the pool's terminate() ends a worker even when the parent had installed
    its own handler before forking."""
    signal.signal(signal.SIGTERM, signal.SIG_DFL)


def _pool_map(fn, items: list, n_workers: int | None) -> list:
    """fn over items, in n_workers spawned processes when more than one
    (None = one per CPU, at most one per item)."""
    if n_workers is None:
        n_workers = min(os.cpu_count() or 1, len(items))
    if n_workers > 1:
        import multiprocessing
        ctx = multiprocessing.get_context('spawn')
        with ctx.Pool(n_workers, initializer=_default_sigterm) as pool:
            return pool.map(fn, items)
    return [fn(x) for x in items]


def _load_maps(files: list[str], Rs_per_ds: float,
               n_workers: int | None) -> list[dict]:
    import functools
    return _pool_map(functools.partial(load_map_data, Rs_per_ds=Rs_per_ds), files,
                     n_workers)


def build_single_channel_data(data_path, working_dir: str,
                              Rs_per_ds: float = 1.0,
                              seconds_per_dt: float = 86400.0,
                              ref_time: Optional[datetime] = None,
                              batch_size: int = 1024,
                              n_devices: int = 1,
                              debug: bool = False,
                              n_workers: int | None = None,
                              seed: int = 42) -> RayData:
    """Emission-head pipeline: all pixels of all maps flattened to rays, one
    held-out validation image at index len//6, global shuffle, npy shards.

    data_path may be one glob string, or a {name: glob} dict (or list of
    globs) naming multiple datasets of unequal size — smaller datasets are
    then resampled *with replacement* up to the largest so every training
    step sees all sources in equal proportion (the reference's multi-dataset
    multiplexing, base_loader.py:44-55: RandomSampler(replacement=True,
    num_samples=len(ref_dataset)) on every non-reference loader). Per-ray
    provenance ids are kept in extras['dataset_ids_path'] / the saved
    dataset_ids_batches.npy for balance checks; the held-out validation image
    comes from the largest (reference) dataset.

    batch_size is per-chip; the global batch is batch_size * n_devices
    (reference single_channel.py:67-68 scaled by N_GPUS). n_workers > 1
    fans FITS loading out over processes (reference base_loader.py:72-74)."""
    if isinstance(data_path, dict):
        source_globs = dict(data_path)
    elif isinstance(data_path, (list, tuple)):
        source_globs = {f'dataset_{i}': g for i, g in enumerate(data_path)}
    else:
        source_globs = {'tracing': data_path}

    source_files = {}
    for name, pattern in source_globs.items():
        files = sorted(glob.glob(pattern))
        if debug:
            files = files[::10]
        if not files:
            raise FileNotFoundError(f'no FITS files match {pattern!r} '
                                    f'(dataset {name!r})')
        source_files[name] = files

    all_files = [f for fs in source_files.values() for f in fs]
    all_maps = _load_maps(all_files, Rs_per_ds, n_workers)
    maps_by_source, i = {}, 0
    for name, fs in source_files.items():
        maps_by_source[name] = all_maps[i:i + len(fs)]
        i += len(fs)

    o_times = [m['time'] for m in all_maps]
    ref_time = ref_time or min(o_times)

    def flatten(maps_sel):
        r = np.concatenate([m['all_rays'] for m in maps_sel])
        t = np.concatenate([
            np.full((m['all_rays'].shape[0], 1),
                    normalize_datetime(m['time'], seconds_per_dt, ref_time),
                    np.float32) for m in maps_sel])
        im = np.concatenate([m['image'].reshape(-1, 1) for m in maps_sel])
        return r, t, im.astype(np.float32)

    # reference dataset = the one with the most maps; its len//6 image is the
    # held-out validation view (reference single_channel.py:35-39)
    ref_name = max(maps_by_source, key=lambda k: len(maps_by_source[k]))
    ref_maps = maps_by_source[ref_name]
    if len(ref_maps) < 2:
        raise ValueError(
            f'need >= 2 maps in the largest dataset (one is held out for '
            f'validation); {source_globs[ref_name]!r} matched {len(ref_maps)}')
    test_idx = len(ref_maps) // 6
    valid_rays, valid_times, valid_images = flatten([ref_maps[test_idx]])

    rng = np.random.default_rng(seed)
    per_source, ids = [], []
    n_ref = sum(m['all_rays'].shape[0] for i, m in enumerate(ref_maps)
                if i != test_idx)
    for src_id, (name, maps_sel) in enumerate(maps_by_source.items()):
        if name == ref_name:
            maps_sel = [m for i, m in enumerate(maps_sel) if i != test_idx]
        r, t, im = flatten(maps_sel)
        if name != ref_name and r.shape[0] != n_ref:
            idx = rng.integers(0, r.shape[0], n_ref)
            r, t, im = r[idx], t[idx], im[idx]
        per_source.append((r, t, im))
        ids.append(np.full(r.shape[0], src_id, np.int16))

    train_rays = np.concatenate([s[0] for s in per_source])
    train_times = np.concatenate([s[1] for s in per_source])
    train_images = np.concatenate([s[2] for s in per_source])
    train_ids = np.concatenate(ids)

    perm = rng.permutation(train_rays.shape[0])
    shard_paths = _save_shards(working_dir, {
        'rays': train_rays[perm], 'times': train_times[perm],
        'images': train_images[perm]})
    ids_path = os.path.join(working_dir, 'dataset_ids_batches.npy')
    np.save(ids_path, train_ids[perm])

    global_batch = int(batch_size) * int(n_devices)
    train_ds = MmapDataset(shard_paths, batch_size=global_batch)
    valid_ds = ArrayDataset({'rays': valid_rays, 'time': valid_times,
                             'target_image': valid_images},
                            batch_size=global_batch)

    config = {'type': 'emission', 'Rs_per_ds': Rs_per_ds,
              'seconds_per_dt': seconds_per_dt,
              'ref_time': ref_time.isoformat(),
              'resolution': list(ref_maps[0]['image'].shape),
              'wavelength': ref_maps[0]['wavelength'],
              'times': [t.isoformat() for t in o_times],
              'datasets': {name: len(maps_sel)
                           for name, maps_sel in maps_by_source.items()}}
    return RayData(train=train_ds, valid=valid_ds, config=config,
                   ref_time=ref_time, Rs_per_ds=Rs_per_ds,
                   seconds_per_dt=seconds_per_dt,
                   validation_shape=tuple(ref_maps[0]['image'].shape),
                   extras={'dataset_ids_path': ids_path,
                           'dataset_names': list(maps_by_source),
                           'overview': {
                               'poses': np.stack([m['pose']
                                                  for m in all_maps]),
                               'times': np.asarray(
                                   [normalize_datetime(m['time'],
                                                       seconds_per_dt,
                                                       ref_time)
                                    for m in all_maps], np.float32),
                               'images': [m['image'] for m in all_maps[:4]],
                           }})


# ------------------------------------------------------------- multi-thermal

_DATE_RE = re.compile(r'(\d{4}-\d{2}-\d{2})T(\d{2}[:\.]?\d{2}(?:[:\.]?\d{2})?)')


def date_from_filename(path: str) -> datetime:
    """Parse the observation datetime out of a filename containing
    'YYYY-MM-DDTHH[:MM[:SS]]' (reference dates_from_filenames,
    multi_thermal_loader.py:96-117)."""
    name = os.path.basename(path)
    m = _DATE_RE.search(name)
    if not m:
        raise ValueError(f'no datetime in filename {name}')
    date, time = m.group(1), m.group(2).replace('.', ':')
    parts = time.split(':') if ':' in time else [time[i:i + 2] for i in
                                                 range(0, len(time), 2)]
    parts += ['00'] * (3 - len(parts))
    return datetime.fromisoformat(f'{date}T{parts[0]}:{parts[1]}:{parts[2]}')


def _round_5min(t: datetime) -> datetime:
    import datetime as _dt
    discard = _dt.timedelta(minutes=t.minute % 5, seconds=t.second,
                            microseconds=t.microsecond)
    t -= discard
    if discard >= _dt.timedelta(minutes=2.5):
        t += _dt.timedelta(minutes=5)
    return t


def scan_instrument_tree(data_path: str) -> dict:
    """Recursive scan: <data_path>/<instrument>/<wavelength>/*.fits grouped
    per instrument with the union wavelength set and per-source presence masks
    (multi_thermal_loader.py:142-187)."""
    all_fits = sorted(glob.glob(os.path.join(data_path, '**', '*.fits'),
                                recursive=True))
    source_paths = sorted({os.path.dirname(os.path.dirname(f)) for f in all_fits})

    sources = {}
    union = set()
    for path in source_paths:
        wls = sorted(int(d) for d in os.listdir(path)
                     if os.path.isdir(os.path.join(path, d)) and d.isdigit())
        sources[os.path.basename(path)] = {'path': path, 'wavelengths': wls}
        union.update(wls)
    union = np.asarray(sorted(union), np.int64)

    for src in sources.values():
        mask = np.isin(union, src['wavelengths'])
        src['wavelengths'] = union * mask  # 0 where the channel is absent

        # inner-join the per-wavelength file lists on 5-minute-rounded times
        stacks_by_time = None
        for wl in src['wavelengths']:
            if wl == 0:
                continue
            files = sorted(glob.glob(os.path.join(src['path'], str(wl), '*.fits')))
            by_time = {}
            for f in files:
                key = _round_5min(date_from_filename(f))
                by_time.setdefault(key, f)
            if stacks_by_time is None:
                stacks_by_time = {k: [v] for k, v in by_time.items()}
            else:
                stacks_by_time = {k: stack + [by_time[k]]
                                  for k, stack in stacks_by_time.items()
                                  if k in by_time}
        src['file_stacks'] = [stacks_by_time[k]
                              for k in sorted(stacks_by_time or {})]
    return {'sources': sources, 'all_wavelengths': union}


def _load_stack(stack_paths, wavelengths, Rs_per_ds, seconds_per_dt, ref_time,
                target_resolution=None):
    """One time-aligned wavelength stack -> per-pixel ray/image/wavelength
    rows (multi_thermal_loader.py:209-258); wavelengths is the source's row
    of the union set, 0 where it lacks a channel."""
    imgs, header0 = [], None
    for p in stack_paths:
        data, header = read_fits(p)
        imgs.append(remove_nans(data))
        if header0 is None:
            header0 = header
    stack = np.stack(imgs)  # [n_present, H, W]

    if target_resolution is not None:
        factor = stack.shape[1] // int(target_resolution)
        if factor > 1:
            stack = block_reduce_mean(stack, factor)

    obs = parse_observer(header0)
    time = normalize_datetime(obs.time, seconds_per_dt, ref_time)
    pose = pose_spherical(-obs.carrington_lon, obs.carrington_lat,
                          obs.dsun_rs / Rs_per_ds)
    tx, ty = helioprojective_grid(header0, shape=(stack.shape[1], stack.shape[2]))
    rays_o, rays_d = get_rays(tx, ty, pose)
    all_rays = np.stack([rays_o, rays_d], axis=-2).reshape(-1, 2, 3)

    n_wl = len(wavelengths)
    h, w = stack.shape[1:]
    extended = np.zeros((n_wl, h, w), np.float32)
    wl_stack = np.zeros((n_wl, h, w), np.float32)
    n = 0
    for i, wl in enumerate(wavelengths):
        if wl != 0:
            extended[i] = stack[n]
            wl_stack[i] = wl
            n += 1

    return {
        'image': extended.transpose(1, 2, 0).reshape(-1, n_wl),
        'wavelength': wl_stack.transpose(1, 2, 0).reshape(-1, n_wl),
        'all_rays': all_rays,
        'time': np.full((all_rays.shape[0], 1), time, np.float32),
        'pose': pose, 'shape': (h, w),
    }


def _load_stack_job(job):
    return _load_stack(*job)


def build_multi_thermal_data(data_path: str, working_dir: str,
                             Rs_per_ds: float = 1.0,
                             seconds_per_dt: float = 86400.0,
                             ref_time: Optional[datetime] = None,
                             batch_size: int = 1024,
                             n_devices: int = 1,
                             target_resolution: Optional[int] = None,
                             debug: bool = False,
                             n_workers: int | None = None,
                             seed: int = 42) -> RayData:
    """DT-head pipeline: per-source wavelength stacks joined on rounded
    datetimes (scan_instrument_tree), per-pixel wavelength vectors over the
    union of channels with 0 where a source lacks one, the held-out stack
    at len//6, a numpy default_rng(seed) shuffle and npy shards, as the JAX
    package builds them. n_workers > 1 loads the stacks in that many
    spawned processes (None = one per CPU)."""
    tree = scan_instrument_tree(data_path)
    union = tree['all_wavelengths']

    if ref_time is None:
        first = []
        for src in tree['sources'].values():
            if src['file_stacks']:
                first.append(date_from_filename(src['file_stacks'][0][0]))
        ref_time = min(first)

    jobs = []
    for src in tree['sources'].values():
        stacks = src['file_stacks'][::10] if debug else src['file_stacks']
        jobs += [(stack, src['wavelengths'], Rs_per_ds, seconds_per_dt, ref_time,
                  target_resolution) for stack in stacks]
    if not jobs:
        raise FileNotFoundError(f'no instrument/wavelength FITS under {data_path}')
    records = _pool_map(_load_stack_job, jobs, n_workers)

    valid_idx = len(records) // 6
    valid = records[valid_idx]
    train = [r for i, r in enumerate(records) if i != valid_idx]

    rays = np.concatenate([r['all_rays'] for r in train])
    times = np.concatenate([r['time'] for r in train])
    images = np.concatenate([r['image'] for r in train])
    wls = np.concatenate([r['wavelength'] for r in train])

    rng = np.random.default_rng(seed)
    perm = rng.permutation(rays.shape[0])
    shard_paths = _save_shards(working_dir, {
        'rays': rays[perm], 'times': times[perm], 'images': images[perm],
        'wavelengths': wls[perm]})

    global_batch = int(batch_size) * int(n_devices)
    train_ds = MmapDataset(shard_paths, batch_size=global_batch)
    valid_ds = ArrayDataset({'rays': valid['all_rays'], 'time': valid['time'],
                             'target_image': valid['image'],
                             'wavelength': valid['wavelength']},
                            batch_size=global_batch)

    config = {'type': 'D_T', 'Rs_per_ds': Rs_per_ds,
              'seconds_per_dt': seconds_per_dt,
              'ref_time': ref_time.isoformat(),
              'wavelengths': union.tolist(),
              'resolution': list(valid['shape'])}
    return RayData(train=train_ds, valid=valid_ds, config=config,
                   ref_time=ref_time, Rs_per_ds=Rs_per_ds,
                   seconds_per_dt=seconds_per_dt,
                   validation_shape=valid['shape'],
                   extras={'overview': {
                       'poses': np.stack([r['pose'] for r in records]),
                       'times': np.asarray([float(r['time'][0, 0])
                                            for r in records], np.float32),
                       'images': [r['image'].reshape(*r['shape'], -1).max(-1)
                                  for r in records[:4]],
                   }})
