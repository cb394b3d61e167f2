"""Serving export: a trained bundle as a torch.export artifact (.tsrv), with
the weights baked in, served by ServingModel without the bundle or its spec
(sunerf_tpu/evaluation/serving.py).

The artifact is a zip container: meta.json and, per platform it was
exported for, two programs saved by torch.export.save, the render entry
(rays -> image, height map, absorption map) and the points entry (a direct
field query, the volume products' load_coords). One program per platform:
the CPU program and the CUDA program differ (the K0 op), so each is traced
on its own device.
  * the CPU program ('cpu') is traced on CPU tensors through the float32
    field, with no custom op, so torch alone loads and runs it (JAX's
    portable module);
  * the CUDA program ('cuda') is traced on the card. Its NeRF fields call K0
    as the registered op sunerf_tpu_torch::fused_mlp_fwd
    (ops/fused_mlp.py), whose operands (k0_field_operands: the wgmma-packed
    weights, the encoding's columns, the biases, the grid tables) are packed
    once, at export, and held as the program's constants, as JAX's fused
    tpu module carries its kernel. It skips the op where JAX skips the fused
    module: grid_rank configs and the non-NeRF heads (simple_star, mhd),
    which run their plain path on the card. Loading such a program needs
    the op registered first, so ServingModel imports the port's op library
    for it (and nvcc builds the kernel at first use): the CUDA program is
    less hermetic than a tpu_custom_call blob.
An MHD spec's cubes are constants of its programs, as in JAX.

A CUDA program is traced on one card (cuda:0 at export) and loads onto any:
ServingModel maps the devices baked into its graph (the factory calls'
device arguments, the constants, the tensor metadata) to the card it serves
on (map_program, torch.export's move_to_device_pass) before it runs it.

Static batch (batch_size rays a call, 4096 by default); ServingModel pads
and chunks any ray count. Rendering is deterministic (no generator: the
midpoint samples); tier=(fraction, samples) bakes the tiered fine pass in
(tier_eval). n_devices > 1 writes format_version 2: each program then takes
batch_size / n_devices rays, and ServingModel(path, mesh=...) gives each
rank its rows of every chunk (parallel/mesh.render_tiled) and all-gathers
them. Unlike JAX's sharded exports, whose pallas_call cannot be
partitioned, each rank's CUDA program keeps the kernel: under an NCCL mesh
rank r serves its rows on cuda:r (scripts/serve_cards.py).

Usage:
  python -m sunerf_tpu_torch.evaluation.serving <bundle> model.tsrv \\
      [--platforms cpu,cuda] [--batch-size 4096] [--tier 0.5,16]
"""
from __future__ import annotations

import dataclasses
import functools
import io
import json
import zipfile
from datetime import datetime
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree

from sunerf_tpu_torch.core.geometry import fov_for_distance, observer_rays
from sunerf_tpu_torch.core.scaling import normalize_datetime
from sunerf_tpu_torch.evaluation.loader import RenderedView
from sunerf_tpu_torch.models.fields import NeRFConfig, _field_output, params_from_numpy
from sunerf_tpu_torch.parallel.mesh import mesh_device, render_tiled

# Reader capability: artifacts are written v1 (one device) or v2
# (n_devices > 1, which needs a mesh to serve)
FORMAT_VERSION = 2
EXTENSION = '.tsrv'
PLATFORMS = ('cpu', 'cuda')
NERF_HEADS = ('emission', 'density_temperature', 'thomson')
_META = 'meta.json'
SHLO = ('is a JAX StableHLO artifact (.shlo) of the sunerf_tpu package, which torch '
        'cannot run: export the bundle with python -m sunerf_tpu_torch.evaluation.serving '
        f'into a {EXTENSION} artifact')


def program_name(entry: str, platform: str) -> str:
    """The zip member of one program: entry 'render' or 'points'."""
    return f'{entry}.{platform}.pt2'


def check_not_shlo(path: str):
    """Raises for a JAX .shlo artifact, which the port cannot run."""
    if str(path).endswith('.shlo'):
        raise ValueError(f'{path} {SHLO}')


def is_artifact(path: str) -> bool:
    """True for a serving artifact (.tsrv); raises for a JAX .shlo."""
    check_not_shlo(path)
    return str(path).endswith(EXTENSION)


def _platform_device(platform: str) -> torch.device:
    if platform not in PLATFORMS:
        raise ValueError(f'unknown platform {platform!r}: the port exports for {PLATFORMS}')
    if platform == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('exporting for cuda traces the program on the card, and there '
                           'is none: pass platforms=("cpu",) (--platforms cpu) to export '
                           'on a CPU host')
    return torch.device(platform)


class _Program(torch.nn.Module):
    """One entry point over a tree of tensors held as buffers, so that
    torch.export.save stores them: forward(*args) = fn(tree, *args)."""

    def __init__(self, fn, tree):
        super().__init__()
        self._fn = fn
        leaves, self._spec = _pytree.tree_flatten(tree)
        self._n = len(leaves)
        seen = set()
        for i, t in enumerate(leaves):
            # a tensor shared by two leaves (the fields' encoding columns, a
            # dict held by both passes) is stored once each
            if t.untyped_storage().data_ptr() in seen:
                t = t.clone()
            seen.add(t.untyped_storage().data_ptr())
            self.register_buffer(f'c{i}', t)

    def forward(self, *args):
        tree = _pytree.tree_unflatten([getattr(self, f'c{i}') for i in range(self._n)],
                                      self._spec)
        return self._fn(tree, *args)


def _packed_apply(config: NeRFConfig, ops: dict, points: torch.Tensor):
    """A NeRF field through the registered K0 op on operands baked in."""
    from sunerf_tpu_torch.ops.fused_mlp import fused_mlp_packed
    return _field_output(config, ops, fused_mlp_packed(ops, points, config.grid_bound))


def _with_op(spec: dict, renderer, params: dict) -> tuple:
    """(renderer, params) whose NeRF fields call the K0 op on their packed
    operands (k0_field_operands, packed here, once), the aux parameters
    (log_abs, vol_c) beside them."""
    from sunerf_tpu_torch.ops.fused_mlp import k0_field_operands
    fine = NeRFConfig(**spec['model_config'])
    coarse = NeRFConfig(**spec.get('coarse_model_config') or spec['model_config'])
    packed = dict(params)
    for key, config in (('fine', fine), ('coarse', coarse)):
        p = params[key]
        _, ops = k0_field_operands(config, p)
        packed[key] = dict(ops, **{k: p[k] for k in ('log_abs', 'vol_c') if k in p})
    coarse_apply = (functools.partial(_packed_apply, coarse)
                    if renderer.coarse_field_apply is not None else None)
    return dataclasses.replace(renderer, field_apply=functools.partial(_packed_apply, fine),
                               coarse_field_apply=coarse_apply), packed


def map_program(program, mapping: dict):
    """An ExportedProgram with its devices mapped ({'cuda:0': 'cuda:1'}):
    every device argument of its graph, its constants, buffers and tensor
    metadata (torch.export.passes.move_to_device_pass, in place). A device
    that `mapping` does not name stays."""
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(program, {str(k): str(v) for k, v in mapping.items()})


def _cards_to(device: torch.device) -> dict:
    """The mapping that moves a CUDA program traced on any card of this
    host (or on 'cuda', no index) to `device`."""
    return {'cuda': device, **{f'cuda:{i}': device for i in range(torch.cuda.device_count())}}


def _trace(fn, tree, args) -> bytes:
    program = torch.export.export(_Program(fn, tree), args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_programs(spec: dict, params_np: dict, device, batch_size: int, n_channels: int,
                    tier: Optional[tuple] = None, fused: bool = False,
                    points_batch: Optional[int] = None) -> tuple:
    """(render program, points program) of one device as torch.export.save
    bytes, and whether they call the K0 op. fused: the NeRF fields through
    the registered op (on the CPU its plain version), where the spec has
    a kernel (a NeRF head without grid_rank); else the float32 field."""
    from sunerf_tpu_torch.systems import from_spec
    device = torch.device(device)
    mc = spec.get('model_config') or {}
    fused = bool(fused and spec['head'] in NERF_HEADS and not mc.get('grid_rank'))
    renderer, init = from_spec(spec, use_fused=False, device=device)
    params = (params_from_numpy(params_np, device) if params_np is not None else init())
    if tier is not None:
        renderer = dataclasses.replace(renderer, tier_fraction=tier[0],
                                       tier_samples=tier[1], tier_eval=True)
    tree = {'params': params}
    if spec['head'] == 'mhd':
        field = renderer.field_apply.args[0]
        tree['mhd'] = field.tensors()
    if fused:
        renderer, tree['params'] = _with_op(spec, renderer, params)

    def live(tree):
        if 'mhd' not in tree:
            return renderer
        from sunerf_tpu_torch.models.mhd_field import mhd_apply
        field = dataclasses.replace(renderer.field_apply.args[0], **tree['mhd'])
        return dataclasses.replace(renderer, field_apply=functools.partial(mhd_apply, field))

    def render(tree, rays_o, rays_d, times, wl):
        out = live(tree)(tree['params'], rays_o, rays_d, times, generator=None,
                         wavelengths=wl if n_channels else None)
        return out['image'], out['height_map'], out['absorption_map']

    def points(tree, query):
        return live(tree).forward_points(tree['params'], query).raw

    f32 = dict(dtype=torch.float32, device=device)
    rays = (torch.zeros(batch_size, 3, **f32), torch.ones(batch_size, 3, **f32),
            torch.zeros(batch_size, 1, **f32), torch.zeros(batch_size, n_channels, **f32))
    pts = torch.zeros(points_batch or batch_size, 4, **f32)
    return _trace(render, tree, rays), _trace(points, tree, (pts,)), fused


def export_serving(state_path: str, out_path: str, batch_size: int = 4096,
                   platforms: Sequence[str] = PLATFORMS,
                   render_overrides: Optional[dict] = None, n_devices: int = 1,
                   tier: Optional[tuple] = None) -> dict:
    """Export a deployment bundle (save_state npz + json) to a serving
    artifact (a .tsrv zip). Returns its meta (also stored in it).

    batch_size: rays a call, the artifact's static global batch (divided
        over n_devices when sharded).
    platforms: the devices to trace a program on, of ('cpu', 'cuda');
        'cuda' needs the card and raises without one.
    render_overrides: render-section overrides (e.g. a full sample budget
        for a model trained at a reduced one), as in SuNeRFLoader.
    n_devices: > 1 writes a sharded artifact (format 2) for a mesh of that
        many ranks, each program taking batch_size / n_devices rays.
    tier: optional (fraction, samples), the loader's adaptive per-ray
        budgets baked in."""
    from sunerf_tpu_torch.utils.checkpoint import load_state

    params, config = load_state(state_path)
    spec = config.get('renderer_spec')
    if spec is None:
        raise ValueError(f'{state_path} carries no renderer_spec')
    if render_overrides:
        spec = dict(spec, render=dict(spec.get('render', {}), **render_overrides))
    if tier is not None:
        tier = (float(tier[0]), int(tier[1]))
        if not 0.0 < tier[0] < 1.0:
            raise ValueError(f'tier fraction must be in (0, 1), got {tier[0]} (0 would '
                             'silently export a full-budget artifact)')
    if n_devices > 1 and batch_size % n_devices:
        raise ValueError(f'batch_size {batch_size} not divisible by n_devices {n_devices}')
    platforms = list(platforms)
    devices = [_platform_device(p) for p in platforms]
    wavelengths = config.get('wavelengths')
    n_ch = len(wavelengths) if wavelengths else 0

    blobs, fused_cuda = {}, False
    for platform, device in zip(platforms, devices):
        render, points, op = export_programs(
            spec, params, device, batch_size // n_devices, n_ch, tier,
            fused=platform == 'cuda', points_batch=batch_size)
        blobs[program_name('render', platform)] = render
        blobs[program_name('points', platform)] = points
        fused_cuda = fused_cuda or op
    meta = {
        'format_version': 2 if n_devices > 1 else 1,
        'batch_size': int(batch_size),
        'n_devices': int(n_devices),
        'tier': list(tier) if tier is not None else None,
        'fused_cuda': fused_cuda,
        'platforms': platforms,
        'n_channels': n_ch,
        'wavelengths': wavelengths,
        'ref_time': config.get('ref_time'),
        'seconds_per_dt': config.get('seconds_per_dt', 86400.0),
        'Rs_per_ds': config.get('Rs_per_ds', 1.0),
        'renderer_spec': spec,
        'torch_version': torch.__version__,
    }
    with zipfile.ZipFile(out_path, 'w', zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_META, json.dumps(meta, indent=1))
        for name, blob in blobs.items():
            zf.writestr(name, blob)
    return meta


class ServingModel:
    """Run a .tsrv serving artifact: pad and chunk any ray count through its
    fixed-batch program for `device` ('cuda', the default: the current card,
    which raises without one; 'cuda:k', any card of the host; 'cpu'). mesh: a
    parallel.mesh.Mesh for a sharded artifact (n_devices ranks), each rank
    serving on the mesh's device."""

    def __init__(self, path: str, device='cuda', mesh=None):
        check_not_shlo(path)
        with zipfile.ZipFile(path) as zf:
            self.meta = json.loads(zf.read(_META))
            if self.meta.get('format_version', 0) > FORMAT_VERSION:
                raise ValueError(f'artifact format v{self.meta["format_version"]} is newer '
                                 f'than this runtime (v{FORMAT_VERSION})')
            if mesh is not None:
                device = mesh_device(mesh, device)
            self.device = torch.device(device)
            platform = self.device.type
            if platform == 'cuda' and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: the artifact's CUDA program runs on the "
                                   "card; pass device='cpu' for its CPU program")
            if platform not in self.meta['platforms']:
                raise ValueError(f'{path} has no program for {platform}: it was exported '
                                 f'for {self.meta["platforms"]}')
            if platform == 'cuda':
                if self.device.index is None:
                    self.device = torch.device('cuda', torch.cuda.current_device())
                if self.meta.get('fused_cuda'):
                    # the program calls sunerf_tpu_torch::fused_mlp_fwd: register it
                    import sunerf_tpu_torch.ops.fused_mlp  # noqa: F401
            self._render = self._load(zf, program_name('render', platform))
            self._points = self._load(zf, program_name('points', platform))
        self.batch_size = int(self.meta['batch_size'])
        self.n_channels = int(self.meta['n_channels'])
        self.n_devices = int(self.meta.get('n_devices', 1))
        size = 1 if mesh is None else mesh.size
        if size != self.n_devices:
            raise ValueError(f'artifact was exported for {self.n_devices} ranks; serving on '
                             f'{size} (pass a mesh of that size)')
        self.mesh = mesh

    def _load(self, zf: zipfile.ZipFile, name: str):
        """A program of the artifact, a CUDA one mapped onto self.device."""
        program = torch.export.load(io.BytesIO(zf.read(name)))
        if self.device.type == 'cuda':
            program = map_program(program, _cards_to(self.device))
        return program.module()

    @property
    def wavelengths(self):
        return self.meta.get('wavelengths')

    def _tensor(self, x, cols: int) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32).reshape(-1, cols)).to(self.device)

    def __call__(self, rays_o, rays_d, times, wavelengths=None) -> dict:
        """Render [N] rays -> dict(image [N, C], height_map [N],
        absorption_map [N]) as numpy; N arbitrary (padded with zeros to
        whole batches)."""
        rays_o, rays_d = self._tensor(rays_o, 3), self._tensor(rays_d, 3)
        n = rays_o.shape[0]
        times = self._tensor(times, 1).expand(n, 1).contiguous()
        if wavelengths is None:
            wl = np.asarray(self.meta['wavelengths'] or [], np.float32)
        else:
            wl = np.asarray(wavelengths, np.float32)
        wl = torch.as_tensor(np.broadcast_to(wl, (n, self.n_channels)).copy()).to(self.device)
        inputs = {'rays_o': rays_o, 'rays_d': rays_d, 'times': times, 'wl': wl}
        with torch.inference_mode():
            outs = render_tiled(self.mesh, inputs, self.batch_size,
                                lambda rows: list(self._render(*rows.values())), pad=True)
        return {k: x.cpu().numpy() for k, x in
                zip(('image', 'height_map', 'absorption_map'), outs)}

    def query_points(self, query_points) -> np.ndarray:
        """Direct field query at [N, 4] (x, y, z, t) points, the
        ModelLoader.load_coords contract: raw [N, d_output] head inputs."""
        q = self._tensor(query_points, 4)
        with torch.inference_mode():
            out, = render_tiled(None, {'q': q}, self.batch_size,
                                lambda rows: [self._points(rows['q'])], pad=True)
        return out.cpu().numpy()

    # ModelLoader.load_coords alias, so the volume products take artifacts
    def load_coords(self, query_points, batch_size=None) -> np.ndarray:
        return self.query_points(query_points)

    def normalize_time(self, time) -> float:
        if isinstance(time, datetime):
            ref = self.meta.get('ref_time')
            if ref is None:
                raise ValueError('datetime given but artifact has no ref_time')
            return normalize_datetime(time, self.meta['seconds_per_dt'],
                                      datetime.fromisoformat(ref))
        return float(time)

    def render_observer_image(self, lat: float, lon: float, time, distance: float,
                              resolution: int = 256, wavelengths=None,
                              fov: Optional[float] = None) -> RenderedView:
        """Full-disk render from Carrington (lat, lon) [rad], the
        ModelLoader.render_observer_image contract on the artifact."""
        rays_o, rays_d = observer_rays(lat, lon, distance, resolution,
                                       fov=fov or fov_for_distance(distance))
        out = self(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                   np.full((resolution * resolution, 1), self.normalize_time(time),
                           np.float32), wavelengths=wavelengths)
        res = (resolution, resolution)
        return RenderedView(image=out['image'].reshape(*res, -1),
                            height_map=out['height_map'].reshape(res),
                            absorption_map=out['absorption_map'].reshape(res))


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description=f'Export a trained bundle to a torch.export serving artifact ({EXTENSION})')
    parser.add_argument('state', help='deployment bundle (save_state path)')
    parser.add_argument('out', help=f'output {EXTENSION} artifact')
    parser.add_argument('--batch-size', type=int, default=4096)
    parser.add_argument('--platforms', default=','.join(PLATFORMS),
                        help="comma-separated devices to trace a program on; 'cuda' needs "
                             "the card (pass --platforms cpu on a CPU host)")
    parser.add_argument('--n-devices', type=int, default=1,
                        help='>1 writes a sharded artifact for a mesh of that many ranks')
    parser.add_argument('--tier', default=None, metavar='FRAC,SAMPLES',
                        help="bake adaptive per-ray budgets in, e.g. '0.5,16'")
    parser.add_argument('--n-stratified', type=int, default=None,
                        help='override the render sample budget')
    parser.add_argument('--n-hierarchical', type=int, default=None)
    args = parser.parse_args(argv)
    overrides = {}
    if args.n_stratified is not None:
        overrides['n_stratified'] = args.n_stratified
    if args.n_hierarchical is not None:
        overrides['n_hierarchical'] = args.n_hierarchical
    tier = None
    if args.tier:
        frac, samples = args.tier.split(',')
        tier = (float(frac), int(samples))
    meta = export_serving(args.state, args.out, batch_size=args.batch_size,
                          platforms=tuple(args.platforms.split(',')),
                          render_overrides=overrides or None,
                          n_devices=args.n_devices, tier=tier)
    print(json.dumps({'out': args.out, 'platforms': meta['platforms'],
                      'batch_size': meta['batch_size'], 'n_devices': meta['n_devices'],
                      'fused_cuda': meta['fused_cuda'],
                      'torch_version': meta['torch_version']}))


if __name__ == '__main__':
    main()
