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
              without its epilogue (8); its epilogue without the products (9).

    python -m sunerf_tpu_torch.scripts.backward_ablation [--fmt lsb] [--n N]

The variants give wrong gradients; they are timed, never used. One JSON
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
from sunerf_tpu_torch.scripts.ab_rows import _by_kernel, _events_ms

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


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--fmt', default='lsb', choices=sorted(VARIANTS))
    parser.add_argument('--n', type=int, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('backward_ablation: no CUDA device; it measures the card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
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
