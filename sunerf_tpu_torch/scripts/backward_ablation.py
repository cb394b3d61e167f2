"""Ablations of the 'lsb' and 'i8pair' stashing backwards (K6a, K6b) on the
card: the backward with the point cotangent at 8x512, N = 262,144 (the
kernel table's rows), built from the same sources with SUNERF_ABLATION
(csrc/fused_mlp_backward.cuh):

  'lsb'     as built; the gate loaded but not decoded (1: its bits taken as
            a bf16 gate); decoded but not loaded (2: no gate boxes copied,
            bits made from each element's row and column);
  'i8pair'  as built; dw_i8_wgmma_kernel without its operand builds (3: the
            int8 products on whatever the buffers hold); without its
            products (4: the loads and builds alone); the chain kernel
            without its row maxima (5: the groups' scales garbage).

    python -m sunerf_tpu_torch.scripts.backward_ablation [--fmt lsb] [--n 262144]

The variants give wrong gradients; they are timed, never used. One JSON
line: each variant's backward by CUDA events (median of 5 calls) and its
device ms by kernel name in one call under torch.profiler. Weights from
seed 7, points U(-1.3, 1.3) and dy normal from the same generator.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf
from sunerf_tpu_torch.ops import fused_mlp
from sunerf_tpu_torch.scripts.ab_rows import _by_kernel, _events_ms

VARIANTS = {
    'lsb': (('as built', ()),
            ('loaded, not decoded', ('SUNERF_ABLATION=1',)),
            ('decoded, not loaded', ('SUNERF_ABLATION=2',))),
    'i8pair': (('as built', ()),
               ('dW_h without operand builds', ('SUNERF_ABLATION=3',)),
               ('dW_h without products', ('SUNERF_ABLATION=4',)),
               ('chain without row maxima', ('SUNERF_ABLATION=5',))),
}


def measure(fmt: str = 'lsb', n: int = 262144, device='cuda') -> dict:
    """{variant: {'ms': backward ms, 'kernels': {name: {'ms', 'launches'}}}}."""
    config = emission_config()
    gen = torch.Generator(device=device).manual_seed(7)
    params = init_nerf(gen, config, device)
    pts = torch.rand(n, 4, generator=gen, device=device) * 2.6 - 1.3
    dy = torch.randn(n, config.d_output, generator=gen, device=device)
    rows = {}
    with torch.no_grad():
        _, hs, _ = fused_mlp.fused_mlp_stash_forward(config, params, pts, fmt)
        for tag, defines in VARIANTS[fmt]:
            fn = (lambda d=defines: fused_mlp._stash_backward_launch(
                config, params, pts, dy, hs, None, fmt, True, fused_mlp.STASH_BWD_TILE,
                defines=d))
            rows[tag] = dict(ms=_events_ms(fn, reps=5), kernels=_by_kernel(fn))
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--fmt', default='lsb', choices=sorted(VARIANTS))
    parser.add_argument('--n', type=int, default=262144)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('backward_ablation: no CUDA device; it measures the card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    rows = measure(args.fmt, args.n)
    for tag, r in rows.items():
        print(f"[backward_ablation] {args.fmt} backward with K3, 8x512 N={args.n}, {tag}: "
              f"{r['ms']:.3f} ms; " + '; '.join(f"{k} x{v['launches']} {v['ms']:.3f}"
                                                  for k, v in r['kernels'].items()), flush=True)
    out = dict(card=card, fmt=args.fmt, n=args.n, variants=rows)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
