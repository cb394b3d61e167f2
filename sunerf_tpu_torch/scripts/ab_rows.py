"""The rows a kernel redesign is held to, measured in one checkout of the port
on the card, for a parent/change A/B on one machine:

    for tree in parent change change parent; do
        (cd $tree && python3 /path/to/sunerf_tpu_torch/scripts/ab_rows.py --tag $tree)
    done

Run from a checkout's root: it imports the sunerf_tpu_torch of the current
directory, and uses only entry points that every port slice has, so the same
file measures the parent and the change. One JSON line:
  * k0_fine_ms, k0_coarse_ms: K0 (fused_mlp_forward, no grad) with the
    committed bundle's two fields at one render chunk's shapes (4096 rays x
    60 and x 20 samples), points U(-1.3, 1.3) from seed 0;
  * render_256_ms: SuNeRFLoader.render_observer_image of the bundle at
    256x256, lat 0.3, lon 1.1, 215 Rs, host clock to the host copy;
  * step_ms: bench.py's training step (scripts/probe_step.py's setup, knobs
    {}), CUDA events around whole steps;
  * k1_ms, k2_ms: the stashing forward and backward at 8x512, N = 196,608
    (the training step's fine field), weights and points from seed 2;
  * k2_same_bits: two runs of that backward give the same gradients, bit
    for bit;
  * dw_h_bmm_ms: the library yardstick for K2's dW part, one torch.bmm of
    the hidden layers' dW_h = hs_{j-1}^T dz_j in bf16 at that shape, hs
    K1's stash and dz normal from seed 2 (the time does not depend on the
    values), both copied contiguous outside the timed region;
  * k2_coarse_ms: the stashing backward at 8x512, N = 65,536 (the step's
    coarse field);
  * k3_fine_ms, k3_4x128_ms: K3, the point cotangent, as the time of the
    stashing backward with compute_dpts less the time without it (turns
    A B B A B A, the median of each), at the fine shape and at 4x128, N =
    20,480 (weights and points from seed 2), with k2_k3_fine_ms and
    k2_k3_4x128_ms the backwards with it;
  * p2_<variant>_ms and grid_sample_ms: P2 at N = 262,144, G = 32, F = 8;
  * i8pair_768_sha256: the i8pair backward's gradients at the default
    group, 8x512, N = 65,536, to hold the bits of the two trees equal;
  * k6b_bwd_ms: the i8pair backward with the point cotangent (K6b with K3)
    at 8x512, N = 262,144, the default group, weights from seed 2;
    k6b_bwd_kernels its device ms by kernel name in one call under
    torch.profiler, and k6b_bwd_peak_gib the memory the call allocates
    beyond what was allocated before it (its outputs included);
  * dw_h_bmm_262k_ms and dw_h_int_mm_ms: library yardsticks of K6b's dW_h
    at that shape, timing rows only (the port calls neither): one bf16
    torch.bmm of the seven hs_{j-1}^T dz_j products (the stash's sin8 as
    bf16, dz normal), and torch._int_mm of the same int8 products, one call
    a layer (7), summed (sin8^T from the stash, dz8 uniform in
    [-127, 127]);
  * k6a_bwd_ms: the lsb backward with the point cotangent (K6a with K3) at
    the same shape, k6a_bwd_kernels by kernel name;
  * k4_ms: the recompute backward (K4, chunks of 32,768 points) at the
    same shape, k4_kernels by kernel name.
P2 and grid_sample times are CUDA graphs of 10 back-to-back calls (the
device's time, not the host's dispatch), the median of 5 replays; K0, K1,
K2 and the step are CUDA events around one call, the median of 10; the
render the host clock, the median of 5; K4, K6a and K6b CUDA events, the
median of 5.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def _graph_ms(fn, calls: int = 10, reps: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='thread_local'):
        outs = [fn() for _ in range(calls)]
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del outs, graph
    return statistics.median(times)


def _events_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _by_kernel(fn) -> dict:
    """Device ms and launches by kernel name (namespaces, template
    arguments and parameters dropped) of one fn() under torch.profiler;
    the throwaway add_ before it may appear as an elementwise kernel of a
    few microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the session's first kernel record is lost: a throwaway kernel takes it
        torch.zeros(1, device='cuda').add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    ms, launches = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA or '#' in evt.name:
            continue
        name = evt.name.replace('(anonymous namespace)::', '').removeprefix('void ')
        name = name.split('<')[0].split('(')[0].rsplit('::', 1)[-1]
        ms[name] = ms.get(name, 0.0) + evt.device_time / 1e3
        launches[name] = launches.get(name, 0) + 1
    return {k: {'ms': ms[k], 'launches': launches[k]} for k in sorted(ms, key=lambda k: -ms[k])}


def _peak_gib(fn) -> float:
    """GiB that one fn() allocates beyond what was allocated before it."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    del out
    return peak


def _k3_ms(fn) -> tuple:
    """(K2 + K3 ms, K3 ms): fn(compute_dpts) timed in turns A B B A B A,
    the median with it less the median without it."""
    runs = {False: [], True: []}
    for with_k3 in (False, True, True, False, False, True):
        runs[with_k3].append(_events_ms(lambda: fn(with_k3), reps=5))
    with_ms = statistics.median(runs[True])
    return with_ms, with_ms - statistics.median(runs[False])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tag', default='')
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('ab_rows: no CUDA device; it measures the card')
    from torch.nn.functional import grid_sample

    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.models.fields import (NeRFConfig, emission_config, init_nerf,
                                                nerf_apply_fused, params_from_numpy)
    from sunerf_tpu_torch.ops import fused_mlp, grid_probes
    from sunerf_tpu_torch.rendering.emission import EmissionHead
    from sunerf_tpu_torch.rendering.renderer import Renderer
    from sunerf_tpu_torch.scripts.probe_step import bench_batch
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step
    from sunerf_tpu_torch.utils.checkpoint import load_state

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    row = {'tag': args.tag, 'tree': os.getcwd(), 'card': smi}
    bundle = 'artifacts_r4/s8_probe_rerun_best'

    # K0 at the bundle's shapes
    params_np, cfg_json = load_state(bundle)
    params = params_from_numpy(params_np, dev)
    spec = cfg_json['renderer_spec']
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for name, key, samples in (('fine', 'model_config', 60),
                                   ('coarse', 'coarse_model_config', 20)):
            cfg = NeRFConfig(**spec[key])
            pts = torch.rand(4096 * samples, 4, generator=gen, device=dev) * 2.6 - 1.3
            pts[:, 3] = 0.0
            p = params[name]
            row[f'k0_{name}_ms'] = _events_ms(lambda: fused_mlp.fused_mlp_forward(cfg, p, pts))

    # the 256^2 render
    loader = SuNeRFLoader(bundle, device='cuda')
    view = dict(lat=0.3, lon=1.1, time=0.0, distance=215.0, resolution=256)
    loader.render_observer_image(**view)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        loader.render_observer_image(**view)
        times.append((time.perf_counter() - t0) * 1e3)
    row['render_256_ms'] = statistics.median(times)
    del loader

    # bench.py's training step
    config = emission_config()
    renderer = Renderer(field_apply=functools.partial(nerf_apply_fused, config),
                        head=EmissionHead())
    g0 = torch.Generator(device=dev).manual_seed(0)
    step_params = {'coarse': init_nerf(g0, config, dev), 'fine': init_nerf(g0, config, dev)}
    opt = make_optimizer()
    step = make_train_step(renderer, LossConfig(), opt)
    state = create_train_state(step_params, opt)
    batch = bench_batch(dev, 1024)
    for _ in range(3):
        step(state, batch, 0)
    row['step_ms'] = _events_ms(lambda: step(state, batch, 0))
    del state, step, renderer

    # K1 and K2 at the step's fine field
    g2 = torch.Generator(device=dev).manual_seed(2)
    p8 = init_nerf(g2, config, dev)
    n = 1024 * 192
    pts = torch.rand(n, 4, generator=g2, device=dev) * 2.6 - 1.3
    dy = torch.randn(n, config.d_output, generator=g2, device=dev)
    with torch.no_grad():
        _, hs, cs = fused_mlp.fused_mlp_stash_forward(config, p8, pts)
        row['k1_ms'] = _events_ms(lambda: fused_mlp.fused_mlp_stash_forward(config, p8, pts))
        row['k2_ms'] = _events_ms(lambda: fused_mlp.fused_mlp_stash_backward(
            config, p8, pts, dy, hs, cs))
        first = fused_mlp.fused_mlp_stash_backward(config, p8, pts, dy, hs, cs)
        again = fused_mlp.fused_mlp_stash_backward(config, p8, pts, dy, hs, cs)
        row['k2_same_bits'] = all(torch.equal(first[k], again[k]) for k in first)
        del first, again
        L, H = config.n_layers, config.d_filter
        hs_t = hs.view(n, L, H)[:, :L - 1].permute(1, 2, 0).contiguous()
        dz = torch.randn((L - 1, n, H), generator=g2, device=dev).to(torch.bfloat16)
        row['dw_h_bmm_ms'] = _events_ms(lambda: torch.bmm(hs_t, dz))
        del hs, cs, hs_t, dz
        m = 65536
        _, hs, cs = fused_mlp.fused_mlp_stash_forward(config, p8, pts[:m])
        row['k2_coarse_ms'] = _events_ms(lambda: fused_mlp.fused_mlp_stash_backward(
            config, p8, pts[:m], dy[:m], hs, cs))
        del hs, cs
        # K3 at the fine shape and at 4x128
        _, hs, cs = fused_mlp.fused_mlp_stash_forward(config, p8, pts)
        row['k2_k3_fine_ms'], row['k3_fine_ms'] = _k3_ms(
            lambda k3: fused_mlp.fused_mlp_stash_backward(config, p8, pts, dy, hs, cs,
                                                          compute_dpts=k3))
        del hs, cs
        small = emission_config(n_layers=4, d_filter=128)
        p4 = init_nerf(g2, small, dev)
        m = 20480
        _, hs, cs = fused_mlp.fused_mlp_stash_forward(small, p4, pts[:m])
        row['k2_k3_4x128_ms'], row['k3_4x128_ms'] = _k3_ms(
            lambda k3: fused_mlp.fused_mlp_stash_backward(small, p4, pts[:m], dy[:m], hs, cs,
                                                          compute_dpts=k3))
        del hs, cs, p4
        # the i8pair backward's bits at the default group
        m = 65536
        _, hs8, _ = fused_mlp.fused_mlp_stash_forward(config, p8, pts[:m], 'i8pair')
        grads = fused_mlp.fused_mlp_stash_backward(config, p8, pts[:m], dy[:m], hs8, None,
                                                   'i8pair')
        torch.cuda.synchronize()
        row['i8pair_768_sha256'] = hashlib.sha256(b''.join(
            grads[k].cpu().numpy().tobytes() for k in sorted(grads))).hexdigest()[:16]
        del hs8, grads, pts, dy
        # K6b's backward with K3 at its table row's shape
        m = 262144
        pts6 = torch.rand(m, 4, generator=g2, device=dev) * 2.6 - 1.3
        dy6 = torch.randn(m, config.d_output, generator=g2, device=dev)
        _, hs8, _ = fused_mlp.fused_mlp_stash_forward(config, p8, pts6, 'i8pair')
        k6b = (lambda: fused_mlp.fused_mlp_stash_backward(
            config, p8, pts6, dy6, hs8, None, 'i8pair', True))
        row['k6b_bwd_ms'] = _events_ms(k6b, reps=5)
        row['k6b_bwd_kernels'] = _by_kernel(k6b)
        row['k6b_bwd_peak_gib'] = _peak_gib(k6b)
        del k6b
        # the library yardsticks of its dW_h (never on the path)
        L, H = config.n_layers, config.d_filter
        s8 = hs8.view(m, L, 2, H)[:, :L - 1, 0].permute(1, 2, 0).contiguous()
        dz8 = torch.randint(-127, 128, (L - 1, m, H), generator=g2, device=dev,
                            dtype=torch.int8)
        row['dw_h_int_mm_ms'] = _events_ms(
            lambda: [torch._int_mm(s8[j], dz8[j]) for j in range(L - 1)], reps=5)
        del dz8
        s16 = s8.to(torch.bfloat16)
        del s8, hs8
        dzb = torch.randn((L - 1, m, H), generator=g2, device=dev).to(torch.bfloat16)
        row['dw_h_bmm_262k_ms'] = _events_ms(lambda: torch.bmm(s16, dzb), reps=5)
        del s16, dzb
        _, hsl, _ = fused_mlp.fused_mlp_stash_forward(config, p8, pts6, 'lsb')
        k6a = (lambda: fused_mlp.fused_mlp_stash_backward(
            config, p8, pts6, dy6, hsl, None, 'lsb', True))
        row['k6a_bwd_ms'] = _events_ms(k6a, reps=5)
        row['k6a_bwd_kernels'] = _by_kernel(k6a)
        del hsl, k6a
        k4 = (lambda: fused_mlp.fused_mlp_recompute_backward(config, p8, pts6, dy6))
        row['k4_ms'] = _events_ms(k4, reps=5)
        row['k4_kernels'] = _by_kernel(k4)
        del k4
        del pts6, dy6

    # P2 and its library call
    n, G, F = 262144, 32, 8
    g3 = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((G * G, G * F), generator=g3, device=dev).to(torch.bfloat16)
    pts3 = torch.rand((n, 3), generator=g3, device=dev) * 2.4 - 1.2
    e1, e2 = (torch.from_numpy(e).to(dev, torch.bfloat16)
              for e in grid_probes.expansion_matrices(G))
    for variant in grid_probes.HAT_VARIANTS:
        ops = (e1, e2) if variant == 'expand' else ()
        row[f'p2_{variant}_ms'] = _graph_ms(
            lambda: grid_probes.hat_encode(table, pts3, G, 1.3, variant, *ops))
    plane = table.float().T.reshape(1, G * F, G, G).contiguous()
    grid = (pts3[:, [2, 1]] / 1.3).reshape(1, n, 1, 2).contiguous()
    row['grid_sample_ms'] = _graph_ms(lambda: grid_sample(
        plane, grid, mode='bilinear', padding_mode='border', align_corners=True))
    print(json.dumps(row), flush=True)
    return row


if __name__ == '__main__':
    main()
