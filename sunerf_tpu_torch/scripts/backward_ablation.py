"""Ablations of the backwards on the card, built from the same sources with
SUNERF_ABLATION (csrc/fused_mlp_backward.cuh), at the kernel table's shapes:

  'lsb'       the 'lsb' backward with K3 (K6a), 8x512, N = 262,144: as
              built; the gate loaded but not decoded (1: its bits taken as a
              bf16 gate); decoded but not loaded (2: no gate boxes copied,
              bits made from each element's row and column);
  'i8pair'    the 'i8pair' backward with K3 (K6b), the same shape: as built;
              dw_i8_wgmma_kernel without its operand builds (3: the int8
              products on whatever the buffers hold); without its products
              (4: the loads and builds alone); the chain kernel without its
              row maxima (5: the groups' scales garbage);
  'recompute' the recompute backward K4, the same shape: as built; its
              forward without the hs / cs stores (6); without its
              reductions (7);
  'dpts'      the 'int8' backward K2 at 8x512, N = 196,608 (the fine step's
              field): without K3, and with it as built; K3's products
              without its epilogue (8); its epilogue without the products (9);
  'grid'      the dense feature-grid branch K5 at the NGP recipe's shape
              (8x512, levels 16 + 32, F = 8, N = 196,608) and at bench.py
              grid_quarter's (4x128, one 16^3 x 8 level, N = 73,728): K0, K1
              and K2 with the grid and at the same widths without it (the
              encoding's grid columns gone), K2's kernels by name in both
              (prep_grid_kernel against prep_kernel, chain_wgmma_kernel with
              and without the grid cotangent; grid_scatter_kernel and
              grid_convert_kernel), and the library yardstick: one
              torch.nn.functional.grid_sample a level (the table as [1, F,
              G, G, G], trilinear, align_corners, border), forward, and
              forward + backward to d_table. The grid's parts are what the
              grid configs add; one variant: the scatter's reds term by
              term, without the warp's merge of equal rows (10), timed at
              the random points and at points along rays (bench.py's 1024
              rays, 192 samples each in ray order, as a training step's
              fine field sends them).

    python -m sunerf_tpu_torch.scripts.backward_ablation [--fmt lsb] [--n N]

The variants give wrong gradients; they are timed, never used ('grid'
runs the kernels as built). One JSON
line: each variant's backward by CUDA events (median of 5 calls) and its
device ms by kernel name in one call under torch.profiler. Weights from
seed 7, points U(-1.3, 1.3) and dy normal from the same generator. The
variants are built first, one nvcc each, all at once.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf
from sunerf_tpu_torch.ops import build, fused_mlp
from sunerf_tpu_torch.scripts.ab_rows import _by_kernel, _events_ms, _graph_ms

# fmt -> (variant, -D macros, with K3) in the order they are timed
VARIANTS = {
    'lsb': (('as built', (), True),
            ('loaded, not decoded', ('SUNERF_ABLATION=1',), True),
            ('decoded, not loaded', ('SUNERF_ABLATION=2',), True)),
    'i8pair': (('as built', (), True),
               ('dW_h without operand builds', ('SUNERF_ABLATION=3',), True),
               ('dW_h without products', ('SUNERF_ABLATION=4',), True),
               ('chain without row maxima', ('SUNERF_ABLATION=5',), True)),
    'recompute': (('as built', (), True),
                  ('forward without hs/cs stores', ('SUNERF_ABLATION=6',), True),
                  ('without reductions', ('SUNERF_ABLATION=7',), True)),
    'dpts': (('K2 without K3', (), False),
             ('K2 + K3 as built', (), True),
             ('K3 products without epilogue', ('SUNERF_ABLATION=8',), True),
             ('K3 epilogue without products', ('SUNERF_ABLATION=9',), True)),
}
DEFAULT_N = {'lsb': 262144, 'i8pair': 262144, 'recompute': 262144, 'dpts': 196608}
# 'grid': (name, config overrides, N), the kernel table's K5 shapes
GRID_SHAPES = (('ngp', dict(grid_sizes=(16, 32), grid_features=8, grid_bound=1.3),
                1024 * 192),
               ('grid_quarter', dict(n_layers=4, d_filter=128, grid_sizes=(16,),
                                     grid_features=8, grid_bound=1.3), 1024 * 72))


def source(fmt: str) -> str:
    """The csrc/<name>.cu whose variants `fmt` times."""
    return 'fused_mlp_recompute_bwd' if fmt == 'recompute' else 'fused_mlp_stash_bwd'


def measure(fmt: str = 'lsb', n: int = None, device='cuda') -> dict:
    """{variant: {'ms': backward ms, 'kernels': {name: {'ms', 'launches'}}}}."""
    n = n or DEFAULT_N[fmt]
    config = emission_config()
    gen = torch.Generator(device=device).manual_seed(7)
    params = init_nerf(gen, config, device)
    pts = torch.rand(n, 4, generator=gen, device=device) * 2.6 - 1.3
    dy = torch.randn(n, config.d_output, generator=gen, device=device)
    builds = sorted({d for _, d, _ in VARIANTS[fmt]})
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda d: build.build(source(fmt), d), builds))
    rows = {}
    with torch.no_grad():
        if fmt == 'recompute':
            hs = cs = None
        else:
            _, hs, cs = fused_mlp.fused_mlp_stash_forward(
                config, params, pts, 'int8' if fmt == 'dpts' else fmt)
        for tag, defines, k3 in VARIANTS[fmt]:
            if fmt == 'recompute':
                fn = (lambda d=defines: fused_mlp._recompute_backward_launch(
                    config, params, pts, dy, defines=d))
            else:
                fn = (lambda d=defines, k=k3: fused_mlp._stash_backward_launch(
                    config, params, pts, dy, hs, cs, 'int8' if fmt == 'dpts' else fmt, k,
                    fused_mlp.STASH_BWD_TILE, defines=d))
            print(f'[backward_ablation] {fmt}: timing {tag!r}', flush=True)
            rows[tag] = dict(ms=_events_ms(fn, reps=5), kernels=_by_kernel(fn))
    return rows


def grid_sample_ms(config, params: dict, pts, device='cuda') -> dict:
    """The library yardstick of K5 (timing only, the port never calls it):
    per level one 5-D grid_sample of the table as [1, F, G(y), G(z), G(x)]
    at the points' (x, z, y) / bound, trilinear, align_corners, border;
    'fwd_ms' the levels' forwards, 'fwd_bwd_ms' forward and backward to
    d_table against a seeded cotangent, both summed over the levels (CUDA
    events, median of 5)."""
    from torch.nn.functional import grid_sample
    from sunerf_tpu_torch.ops.fused_mlp import grid_keys
    n = pts.shape[0]
    grid = (pts[:, [0, 2, 1]] / config.grid_bound).reshape(1, n, 1, 1, 3).contiguous()
    gen = torch.Generator(device=device).manual_seed(11)
    vols = [params[k].detach().permute(3, 0, 1, 2)[None].contiguous().requires_grad_()
            for k in grid_keys(config)]
    cot = torch.randn((1, config.grid_features, n, 1, 1), generator=gen, device=device)

    def fwd():
        with torch.no_grad():
            return [grid_sample(v, grid, mode='bilinear', padding_mode='border',
                                align_corners=True) for v in vols]

    def fwd_bwd():
        with torch.enable_grad():
            outs = [grid_sample(v, grid, mode='bilinear', padding_mode='border',
                                align_corners=True) for v in vols]
            return torch.autograd.grad(outs, vols, [cot] * len(vols))

    return dict(fwd_ms=_events_ms(fwd, reps=5), fwd_bwd_ms=_events_ms(fwd_bwd, reps=5))


def ray_points(n: int, device='cuda') -> torch.Tensor:
    """[n, 4] samples along bench.py's rays (origin (4, 0, 0), directions
    about -x), n / 1024 a ray at stratified depths over [2.7, 5.3], in ray
    order, time 0: consecutive points share grid cells as a training step's
    do."""
    from sunerf_tpu_torch.scripts.probe_step import bench_batch
    rays = bench_batch(device, 1024)['rays']
    s = n // 1024
    gen = torch.Generator(device=device).manual_seed(5)
    t = 2.7 + 2.6 * (torch.arange(s, device=device) + torch.rand(1024, s, generator=gen,
                                                                   device=device)) / s
    pts = rays[:, None, 0] + t[..., None] * rays[:, None, 1]
    return torch.cat([pts.reshape(-1, 3), torch.zeros(n, 1, device=device)], 1).contiguous()


def measure_grid(device='cuda') -> dict:
    """{shape: K0, K1, K2 with and without the grid, K2 by kernel name
    with and without it, the grid's share of K1 + K2 and of each named
    kernel, and grid_sample's times}."""
    variants = [('fused_mlp_stash_bwd', n) for n in (10, 11, 12, 13)] + [
        ('fused_mlp_fwd_wgmma', n) for n in (14, 15)]
    with ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: build.build(v[0], (f'SUNERF_ABLATION={v[1]}',)), variants))
    out = {}
    for name, kw, n in GRID_SHAPES:
        cfg = emission_config(**kw)
        gen = torch.Generator(device=device).manual_seed(n + 7)
        p = init_nerf(gen, cfg, device)
        for k in fused_mlp.grid_keys(cfg):
            p[k] = p[k] * 1e4                      # U(-1, 1): tables that carry signal
        pts = torch.rand(n, 4, generator=gen, device=device) * 3.0 - 1.5
        pts[:, 3] = 0.0
        dy = torch.randn(n, cfg.d_output, generator=gen, device=device)
        base_cfg = emission_config(n_layers=cfg.n_layers, d_filter=cfg.d_filter)
        base = dict(p, w_in=p['w_in'][:base_cfg.d_encoded].contiguous())
        row = {}
        with torch.no_grad():
            for tag, c, q in (('grid', cfg, p), ('no_grid', base_cfg, base)):
                print(f'[backward_ablation] grid: timing {name} {tag}', flush=True)
                _, hs, cs = fused_mlp.fused_mlp_stash_forward(c, q, pts)
                bwd = (lambda c=c, q=q, hs=hs, cs=cs: fused_mlp.fused_mlp_stash_backward(
                    c, q, pts, dy, hs, cs))
                k0 = (lambda c=c, q=q: fused_mlp.fused_mlp_forward(c, q, pts))
                k1 = (lambda c=c, q=q: fused_mlp.fused_mlp_stash_forward(c, q, pts))
                row[tag] = dict(
                    k0_ms=_events_ms(k0), k1_ms=_events_ms(k1), k2_ms=_events_ms(bwd),
                    k0_graph_ms=_graph_ms(k0), k1_graph_ms=_graph_ms(k1),
                    k0_kernels=_by_kernel(k0), k1_kernels=_by_kernel(k1),
                    k2_kernels=_by_kernel(bwd))
                del hs, cs
        g, b = row['grid'], row['no_grid']
        row['share_ms'] = g['k1_ms'] + g['k2_ms'] - b['k1_ms'] - b['k2_ms']
        # prep_grid_kernel is prep_kernel with the grid's features
        row['kernel_share_ms'] = {
            k: v['ms'] - b['k2_kernels'].get(k.replace('prep_grid', 'prep'), {'ms': 0.0})['ms']
            for k, v in g['k2_kernels'].items()}
        row['grid_sample'] = grid_sample_ms(cfg, p, pts, device)
        # the scatter with and without its merge, at these points and along rays
        scatter = {}
        with torch.no_grad():
            for where, q in (('random', pts), ('rays', ray_points(n, device))):
                _, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, q)
                for tag, defines in (('merged', ()), ('term by term', ('SUNERF_ABLATION=10',))):
                    k = _by_kernel(lambda d=defines: fused_mlp._stash_backward_launch(
                        cfg, p, q, dy, hs, cs, 'int8', False, fused_mlp.STASH_BWD_TILE,
                        defines=d))
                    scatter[f'{where}, {tag}'] = k['grid_scatter_kernel']['ms']
                del hs, cs
        row['scatter_ms'] = scatter
        # the chain kernel's grid cotangent taken apart: without its
        # products (11), without its epilogue (12)
        tail = {}
        with torch.no_grad():
            _, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts)
            for tag, defines in (('as built', ()), ('no products', ('SUNERF_ABLATION=11',)),
                                 ('no epilogue', ('SUNERF_ABLATION=12',)),
                                 ('no stores', ('SUNERF_ABLATION=13',))):
                k = _by_kernel(lambda d=defines: fused_mlp._stash_backward_launch(
                    cfg, p, pts, dy, hs, cs, 'int8', False, fused_mlp.STASH_BWD_TILE,
                    defines=d))
                tail[tag] = k['chain_wgmma_kernel']['ms']
            del hs, cs
        row['chain_ms'] = dict(tail, no_grid=row['no_grid']['k2_kernels'][
            'chain_wgmma_kernel']['ms'])
        # K0's grid warp taken apart: staging nothing (14), the consumers
        # neither waiting for it nor copying (15); CUDA graphs of 10 calls
        with torch.no_grad():
            row['k0_graph_ms'] = {
                tag: _graph_ms(lambda d=defines: fused_mlp._forward_k0(cfg, p, pts, defines=d))
                for tag, defines in (('as built', ()), ('grid warp idle', ('SUNERF_ABLATION=14',)),
                                     ('no wait or copy', ('SUNERF_ABLATION=15',)))}
            row['k0_graph_ms']['no_grid'] = row['no_grid']['k0_graph_ms']
        out[name] = dict(n=n, layers=cfg.n_layers, width=cfg.d_filter,
                         levels=list(cfg.grid_sizes), features=cfg.grid_features, **row)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--fmt', default='lsb', choices=sorted(VARIANTS) + ['grid'])
    parser.add_argument('--n', type=int, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('backward_ablation: no CUDA device; it measures the card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    if args.fmt == 'grid':
        rows = measure_grid()
        for name, r in rows.items():
            g, b = r['grid'], r['no_grid']
            print(f"[backward_ablation] grid, {name} {r['layers']}x{r['width']} levels "
                  f"{r['levels']} N={r['n']}: (CUDA events) K0 {g['k0_ms']:.3f} (no grid "
                  f"{b['k0_ms']:.3f}; a CUDA graph of 10 calls {g['k0_graph_ms']:.3f} and "
                  f"{b['k0_graph_ms']:.3f}); K1 by graph {g['k1_graph_ms']:.3f} "
                  f"({b['k1_graph_ms']:.3f}); "
                  f"K1 {g['k1_ms']:.3f} ({b['k1_ms']:.3f}); K2 {g['k2_ms']:.3f} "
                  f"({b['k2_ms']:.3f}); the grid's share of K1 + K2 {r['share_ms']:.3f} ms; "
                  f"by kernel, grid less no grid: " + '; '.join(
                      f'{k} {v:+.3f}' for k, v in r['kernel_share_ms'].items())
                  + f"; grid_sample fwd {r['grid_sample']['fwd_ms']:.3f}, fwd + bwd "
                  f"{r['grid_sample']['fwd_bwd_ms']:.3f}; grid_scatter_kernel " + ', '.join(
                      f'{k} {v:.3f}' for k, v in r['scatter_ms'].items())
                  + '; chain_wgmma_kernel ' + ', '.join(
                      f'{k} {v:.3f}' for k, v in r['chain_ms'].items())
                  + '; K0 by graph ' + ', '.join(
                      f'{k} {v:.3f}' for k, v in r['k0_graph_ms'].items()), flush=True)
        out = dict(card=card, fmt='grid', shapes=rows)
        print(json.dumps(out), flush=True)
        return out
    n = args.n or DEFAULT_N[args.fmt]
    rows = measure(args.fmt, n)
    for tag, r in rows.items():
        print(f"[backward_ablation] {args.fmt}, 8x512 N={n}, {tag}: "
              f"{r['ms']:.3f} ms; " + '; '.join(f"{k} x{v['launches']} {v['ms']:.3f}"
                                                  for k, v in r['kernels'].items()), flush=True)
    out = dict(card=card, fmt=args.fmt, n=n, variants=rows)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
