"""The wide route's GEMM taken apart on the card (csrc/wide_gemm_probe.cu):
one layer's product at 8x1024 widths with each epilogue, the dW products
over the points in ranges against one launch over every layer's tiles, and
'i8pair''s int8 dW_h (wide_dw_i8_wgmma_kernel) with and without its parts.

    python -m sunerf_tpu_torch.scripts.probe_wide_gemm [--n 196608] [--h 1024]
        [--layers 8] [--reps 20] [--out FILE]

Rows, each the ms of a launch (CUDA events around --reps launches back to
back, the median of 3 such runs), at
N = --n points and H = --h (K = H, and K = 64 where only the epilogue
costs): 'products' (no epilogue), 'direct bf16' (bf16(acc) stored a pair at
a time from the accumulators), 'K0' and 'K1' (FwdEpi: the sine, the staged
stores; K1 with the int8 cos8 stash), 'chain' (ChainEpi: the int8 gate
through the ring, the staged dz and its column sums), 'products, N tile
128' and 'K1, N tile 128'; beside them one bf16 torch.matmul of the same
shapes (timed only). Then dW_h of --layers layers over the points: a
launch a layer in dw_plan's ranges (the route's), and one launch over the
layers' stacked tiles in one range (a grouped dW that would keep every
layer's dz). Then one layer's int8 dW_h at the default scale group of 768
(a stash of --layers layers, random int8 sin8, dz normal): in i8_plan's
ranges (the route's) and in one range, and the variants built with
-DSUNERF_WIDE_I8_ABLATION=1 (no operand builds: the ring's loads and the
products alone), =2 (no products: the loads and the builds alone) and =3
(the ring's loads alone),
beside one torch._int_mm of the layer's int8 product (timed only). Prints
one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from sunerf_tpu_torch.ops import build

EPILOGUES = ('products', 'direct bf16', 'K0', 'K1', 'chain', 'products, N tile 128',
             'K1, N tile 128')


def _timed(fn, reps: int) -> float:
    """ms a call of fn: `reps` calls back to back between two CUDA events
    after 3, so that the host's tensor-map encoding and launch overlap the
    device's work as on the route; the median of 3 such runs."""
    for _ in range(3):
        fn()
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return statistics.median(runs)


def _card() -> str:
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def layer_rows(n: int, h: int, reps: int) -> dict:
    """A layer's ms by epilogue at K = h and K = 64, beside torch.matmul."""
    lib = build.load('wide_gemm_probe')
    fn = lib.sunerf_wide_gemm_probe
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for k in (h, 64):
        a = torch.randn(n, k, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(h, k, generator=gen, device=dev) / k ** 0.5).to(torch.bfloat16)
        bias = torch.randn(h, generator=gen, device=dev)
        act = torch.empty(n, h, dtype=torch.bfloat16, device=dev)
        cs = torch.randint(-127, 128, (n, h), generator=gen, device=dev, dtype=torch.int8)
        db_part = torch.empty(2 * -(-n // 128), h, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = {}
        for v, name in enumerate(EPILOGUES):
            def run(v=v):
                err = fn(v, a.data_ptr(), w.data_ptr(), bias.data_ptr(), act.data_ptr(),
                         cs.data_ptr(), db_part.data_ptr(), n, h, k, stream)
                if err:
                    raise RuntimeError(f'wide_gemm_probe {EPILOGUES[v]}: CUDA error {err}')
            row[name] = _timed(run, reps)
        wt = w.t()
        row['torch.matmul'] = _timed(lambda: torch.matmul(a, wt), reps)
        row['tflops_products'] = 2.0 * n * h * k / row['products'] / 1e9
        rows[f'K={k}'] = row
        del a, w, act, cs
    return rows


def dw_rows(n: int, h: int, layers: int, reps: int) -> dict:
    """dW_h of `layers` layers: a launch a layer in ranges, one grouped launch."""
    lib = build.load('wide_gemm_probe')
    fn = lib.sunerf_wide_dw_probe
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1)
    hs = torch.randn(n, layers * h, generator=gen, device=dev).to(torch.bfloat16)
    dz = torch.randn(n, h, generator=gen, device=dev).to(torch.bfloat16)
    part = torch.empty(16 * h * h, device=dev)
    count = torch.zeros(4096, dtype=torch.int32, device=dev)
    per_layer = torch.empty(layers, h, h, device=dev)
    grouped = torch.empty(layers * h, h, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ranged():
        for layer in range(layers):
            if fn(hs[:, layer * h:].data_ptr(), layers * h, dz.data_ptr(), h, h, n, 1,
                  part.data_ptr(), count.data_ptr(), per_layer[layer].data_ptr(), stream):
                raise RuntimeError('wide_dw_probe failed')

    def one():
        if fn(hs.data_ptr(), layers * h, dz.data_ptr(), layers * h, h, n, 0, part.data_ptr(),
              count.data_ptr(), grouped.data_ptr(), stream):
            raise RuntimeError('wide_dw_probe failed')
    ranged()
    one()
    torch.cuda.synchronize()
    ref = hs[:, :h].float().t() @ dz.float()
    return {'ranges_ms': _timed(ranged, reps), 'grouped_ms': _timed(one, reps),
            'ranges_vs_f32': float((per_layer[0] - ref).abs().max() / ref.abs().max()),
            'grouped_vs_ranges': float((grouped.view(layers, h, h) - per_layer).abs().max()
                                       / per_layer.abs().max()),
            'grouped_dz_bytes': layers * n * h * 2}


def i8_rows(n: int, h: int, layers: int, reps: int) -> dict:
    """One layer's int8 dW_h (layer 1 of the stash) in ranges, in one range,
    and without its builds or its products, beside torch._int_mm."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(2)
    ld, group = 2 * layers * h, 768
    stash = torch.randint(-127, 128, (n, ld), generator=gen, device=dev, dtype=torch.int8)
    dz = torch.randn(n, h, generator=gen, device=dev).to(torch.bfloat16)
    gmax = dz.float().abs().amax(1)
    gmax = torch.nn.functional.pad(gmax, (0, -(-n // group) * group - n)).view(-1, group)
    gmax = gmax.amax(1).view(torch.int32).contiguous()
    part = torch.empty(16 * h * h, device=dev)
    count = torch.zeros((-(-h // 128)) ** 2, dtype=torch.int32, device=dev)
    out = torch.empty(h, h, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = {}
    for name, defines, ranged in (('ranges', (), 1), ('one range', (), 0),
                                  ('no builds', ('SUNERF_WIDE_I8_ABLATION=1',), 1),
                                  ('no products', ('SUNERF_WIDE_I8_ABLATION=2',), 1),
                                  ('loads alone', ('SUNERF_WIDE_I8_ABLATION=3',), 1)):
        fn = build.load('wide_gemm_probe', defines).sunerf_wide_dw_i8_probe
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int

        def run(fn=fn, ranged=ranged):
            if fn(stash.data_ptr(), ld, 2 * h, dz.data_ptr(), n, h, gmax.data_ptr(), group,
                  ranged, part.data_ptr(), count.data_ptr(), out.data_ptr(), stream):
                raise RuntimeError('wide_dw_i8_probe failed')
        rows[name] = _timed(run, reps)
    s8 = stash[:, 2 * h:3 * h].t().contiguous()
    dz8 = torch.randint(-127, 128, (n, h), generator=gen, device=dev, dtype=torch.int8)
    rows['torch._int_mm'] = _timed(lambda: torch._int_mm(s8, dz8), reps)
    rows['tops'] = 2.0 * n * h * h / rows['ranges'] / 1e9
    rows['l2_stream_gb'] = n * h * (-(-h // 128) + 2 * -(-h // 128)) / 1e9
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--n', type=int, default=196608)
    parser.add_argument('--h', type=int, default=1024)
    parser.add_argument('--layers', type=int, default=8)
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('probe_wide_gemm measures the card: no CUDA device')
    out = {'card': _card(), 'n': args.n, 'h': args.h,
           'layer': layer_rows(args.n, args.h, args.reps),
           'dw': dw_rows(args.n, args.h, args.layers, args.reps)}
    torch.cuda.empty_cache()
    out['dw_i8'] = i8_rows(args.n, args.h, args.layers, args.reps)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
