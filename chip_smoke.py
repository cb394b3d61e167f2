"""Chip smoke test of the PyTorch / CUDA port (sunerf_tpu_torch) on one
NVIDIA H100: build the hand-written kernels from the sources in this checkout,
hold each against its plain PyTorch version on the card, then serve the
committed 8x512 emission bundle through the port's entry points and check
what comes out.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (the first failure ends the run with a non-zero exit):
  1. build   nvcc builds csrc/fused_mlp_fwd.cu for sm_90a.
  2. kernel  fused_mlp_fwd against fused_mlp_reference on the card, for the
             bundle's two fields at one render chunk's shapes (4096 rays x 60
             fine samples, x 20 coarse samples): per-point |kernel - plain| /
             max|plain| within 2e-2 at the 99.99th percentile, within 1e-1 at
             the maximum, RMS within 2e-3 (see KERNEL_TOL); times by CUDA
             events, median of 20 after warm-up.
  3. render  SuNeRFLoader(bundle, device='cuda').render_observer_image at
             256x256 with the launch count set to 0 just before: 16 chunks x
             (coarse + fine) = 32 launches. Finite products; the image within
             3e-2 of max of the same render with the fields through the
             kernel's plain version on the card. The float32 render (TF32 off)
             is reported beside it: bf16 operands move this trained field's
             render far more than 3e-2, in the JAX package too. At the golden's
             32x32 view: the kernel's image within 3e-2 and the float32 image
             within 1e-2 of the JAX package's own renders
             (sunerf_tpu_torch/assets/s8_golden_32.npz).
  4. flyby   3 frames through evaluation.video.render_video_frames.
Then it prints the card's name and power limit, one {"kernels": [...]} line
and, last, {"ok": true, "device": {...}}.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BUNDLE = 'artifacts_r4/s8_probe_rerun_best'
GOLDEN = 'sunerf_tpu_torch/assets/s8_golden_32.npz'
VIEW = dict(lat=0.3, lon=1.1, time=0.0, distance=215.0)
MAPS = ('image', 'height_map', 'absorption_map')
BF16_TFLOPS = 989.0          # H100 SXM dense bf16 tensor-core peak
# kernel vs plain version, per point, as fractions of max|plain|: the bulk
# (99.99% of points) within 2e-2 and RMS within 2e-3; any point within 1e-1.
# bf16 roundings that flip between the tensor cores' accumulation and
# cuBLAS's compound over this trained field's 8 layers, and a handful of
# hypersensitive points in 10^5 move by a few percent (the plain version on
# the CPU against itself on the card shows the float32-order floor).
KERNEL_TOL = 2e-2
KERNEL_RMS_TOL = 2e-3
KERNEL_MAX_TOL = 1e-1
RENDER_TOL = 3e-2
F32_GOLDEN_TOL = 1e-2


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


def _err_stats(ref: torch.Tensor, got: torch.Tensor) -> dict:
    """Per-point error of got against ref [N, d], as fractions of max|ref|."""
    ref, got = ref.double().cpu(), got.double().cpu()
    d = (got - ref).abs().amax(dim=1)
    m = float(ref.abs().max())
    return dict(max_abs_err=float(d.max()), max_rel_err=float(d.max()) / m,
                p9999_rel_err=float(torch.quantile(d, 0.9999)) / m,
                rms_rel_err=float((got - ref).pow(2).mean().sqrt()
                                  / ref.pow(2).mean().sqrt()),
                points_over_tol=int((d > KERNEL_TOL * m).sum()))


def _fmt(e: dict) -> str:
    return (f"max {e['max_rel_err']:.2e} p99.99 {e['p9999_rel_err']:.2e} rms "
            f"{e['rms_rel_err']:.2e} points>{KERNEL_TOL:g} {e['points_over_tol']}")


def _check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f'chip_smoke FAILED: {what}')


def _cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
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


def _flops(cfg, n: int) -> float:
    h = cfg.d_filter
    return 2.0 * n * h * (cfg.d_encoded + (cfg.n_layers - 1) * h + cfg.d_output)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the card',
              file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    os.chdir(root)
    sys.path.insert(0, str(root))
    from sunerf_tpu_torch.core.geometry import observer_rays
    from sunerf_tpu_torch.evaluation.loader import ModelLoader, SuNeRFLoader
    from sunerf_tpu_torch.evaluation.video import render_video_frames
    from sunerf_tpu_torch.models.fields import (FieldOutput, NeRFConfig,
                                                params_from_numpy)
    from sunerf_tpu_torch.ops import build, fused_mlp
    from sunerf_tpu_torch.systems import from_spec
    from sunerf_tpu_torch.utils.checkpoint import load_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f'device: {torch.cuda.get_device_name(0)} ({smi}), torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}', flush=True)

    # 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _, log = build.build('fused_mlp_fwd')
    print(f'[build] fused_mlp_fwd.cu: {time.perf_counter() - t0:.1f} s', flush=True)
    for line in log.splitlines():
        if 'registers' in line or 'spill' in line:
            print('[build]', line.strip())

    # 2. kernel against its plain version --------------------------------
    params_np, bundle_cfg = load_state(BUNDLE)
    params = params_from_numpy(params_np, device)
    spec = bundle_cfg['renderer_spec']
    render = spec['render']
    fields = {
        'fine': (NeRFConfig(**spec['model_config']),
                 4096 * (render['n_stratified'] + render['n_hierarchical'])),
        'coarse': (NeRFConfig(**spec['coarse_model_config']),
                   4096 * render['n_stratified']),
    }
    gen = torch.Generator(device=device).manual_seed(0)
    kernel_rows = {}
    with torch.inference_mode():
        for name, (cfg, n) in fields.items():
            pts = torch.rand(n, 4, generator=gen, device=device) * 2.6 - 1.3
            pts[:, 3] = 0.0
            p = params[name]
            out = fused_mlp.fused_mlp_forward(cfg, p, pts)
            ref = fused_mlp.fused_mlp_reference(cfg, p, pts)
            torch.cuda.synchronize()
            _check(bool(torch.isfinite(out).all()), f'{name}: non-finite kernel output')
            err = _err_stats(ref, out)
            floor = _err_stats(ref, fused_mlp.fused_mlp_reference(
                cfg, {k: v.cpu() for k, v in p.items()}, pts.cpu()))
            ms = _cuda_ms(lambda: fused_mlp.fused_mlp_forward(cfg, p, pts))
            plain_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_reference(cfg, p, pts))
            bound_ms = _flops(cfg, n) / (BF16_TFLOPS * 1e12) * 1e3
            kernel_rows[name] = dict(n=n, layers=cfg.n_layers, width=cfg.d_filter,
                                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                     **err, plain_cpu_vs_card=floor)
            print(f'[kernel] {name} {cfg.n_layers}x{cfg.d_filter} N={n}: kernel '
                  f'{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms',
                  flush=True)
            print(f'[kernel] {name} kernel vs plain: {_fmt(err)}', flush=True)
            print(f'[kernel] {name} plain on the CPU vs on the card: {_fmt(floor)}',
                  flush=True)
            _check(err['p9999_rel_err'] <= KERNEL_TOL and
                   err['rms_rel_err'] <= KERNEL_RMS_TOL and
                   err['max_rel_err'] <= KERNEL_MAX_TOL,
                   f'{name}: kernel vs plain {_fmt(err)} (tol p99.99 {KERNEL_TOL}, '
                   f'rms {KERNEL_RMS_TOL}, max {KERNEL_MAX_TOL})')

    # 3. render through the port's loader --------------------------------
    loader = SuNeRFLoader(BUNDLE, device='cuda')
    view256 = dict(VIEW, resolution=256)
    loader.render_observer_image(**view256)          # warm-up: weights packed
    torch.cuda.synchronize()
    fused_mlp.LAUNCHES = 0
    view = loader.render_observer_image(**view256)
    launches = fused_mlp.LAUNCHES
    print(f'[render] 256x256: {launches} kernel launches (expected 32)', flush=True)
    _check(launches == 32, f'render launched the kernel {launches} times, not 32')
    for k in MAPS:
        _check(bool(np.isfinite(getattr(view, k)).all()), f'render {k} not finite')
    render_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loader.render_observer_image(**view256)
        render_times.append((time.perf_counter() - t0) * 1e3)
    render_ms = statistics.median(render_times)
    print(f'[render] 256x256 fused: {render_ms:.1f} ms (median of 3, host clock '
          f'to the host copy of the products)', flush=True)

    # where a render's device time goes (torch.profiler over one render)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loader.render_observer_image(**view256)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.device_time / 1e3
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    breakdown = dict(wall_ms=prof_wall_ms, device_ms=device_ms,
                     top={k[:60]: v for k, v in top})
    print(f'[profile] 256x256 render: {prof_wall_ms:.1f} ms wall, {device_ms:.1f} ms '
          f'of device kernels; top: ' + '; '.join(f'{k[:40]} {v:.1f} ms' for k, v in top),
          flush=True)

    # the same render with both fields through the kernel's plain version,
    # and with the float32 field (the JAX package's bf16 kernel is itself
    # 6.6% of max from its float32 render at 32x32: the gap is reported)
    def plain_apply(cfg):
        return lambda p, x: FieldOutput(raw=fused_mlp.fused_mlp_reference(cfg, p, x))
    base, _ = from_spec(spec, use_fused=False, device=device)
    plain_renderer = dataclasses.replace(
        base, field_apply=plain_apply(fields['fine'][0]),
        coarse_field_apply=plain_apply(fields['coarse'][0]))
    plain_view = ModelLoader(plain_renderer, loader.params,
                             device=device).render_observer_image(**view256)
    f32_loader = SuNeRFLoader(BUNDLE, use_fused=False, device='cuda')
    f32_view = f32_loader.render_observer_image(**view256)
    f32_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        f32_loader.render_observer_image(**view256)
        f32_times.append((time.perf_counter() - t0) * 1e3)
    f32_render_ms = statistics.median(f32_times)
    print(f'[render] 256x256 float32 field: {f32_render_ms:.1f} ms (median of 3)',
          flush=True)
    render_err = {}
    for k in MAPS:
        r_plain = _rel(getattr(plain_view, k), getattr(view, k))
        r_f32 = _rel(getattr(f32_view, k), getattr(view, k))
        render_err[k] = dict(vs_plain=r_plain, vs_float32=r_f32)
        print(f'[render] 256x256 {k}: kernel vs plain-version render {r_plain:.3e}'
              f'{f" (tol {RENDER_TOL})" if k == "image" else ""}; vs float32 '
              f'render {r_f32:.3e}', flush=True)
    _check(render_err['image']['vs_plain'] <= RENDER_TOL,
           f"render image: kernel vs plain {render_err['image']['vs_plain']:.3e}")

    golden = np.load(GOLDEN)
    lat, lon, t, dist, res = golden['view']
    gview = dict(lat=float(lat), lon=float(lon), time=float(t),
                 distance=float(dist), resolution=int(res))
    g_fused = loader.render_observer_image(**gview)
    g_f32 = f32_loader.render_observer_image(**gview)
    golden_err = {}
    for k in MAPS:
        golden_err[k] = dict(
            fused=_rel(golden[f'fused/{k}'], getattr(g_fused, k)),
            float32=_rel(golden[f'unfused/{k}'], getattr(g_f32, k)),
            card_fused_vs_f32=_rel(getattr(g_f32, k), getattr(g_fused, k)),
            jax_fused_vs_f32=_rel(golden[f'unfused/{k}'], golden[f'fused/{k}']))
        e = golden_err[k]
        print(f'[golden] {res}x{res} {k}: kernel vs JAX kernel {e["fused"]:.3e}; '
              f'float32 vs JAX float32 {e["float32"]:.3e}; kernel vs float32 '
              f'{e["card_fused_vs_f32"]:.3e} here, {e["jax_fused_vs_f32"]:.3e} '
              f'in JAX', flush=True)
    # float32 conditioning at 1 AU: the float32 render against the same
    # render in float64 on the card, from the same float32 rays
    rays_o, rays_d = observer_rays(gview['lat'], gview['lon'], gview['distance'],
                                   gview['resolution'])
    f64 = lambda x: torch.as_tensor(x.reshape(-1, 3), dtype=torch.float64,
                                    device=device)
    params64 = {f: {k: v.double() for k, v in p.items()} for f, p in params.items()}
    with torch.inference_mode():
        out64 = base(params64, f64(rays_o), f64(rays_d),
                     torch.full((rays_o.shape[0] ** 2, 1), gview['time'],
                                dtype=torch.float64, device=device))
    for k in MAPS:
        golden_err[k]['float32_vs_float64'] = _rel(
            out64[k].cpu().numpy().reshape(getattr(g_f32, k).shape),
            getattr(g_f32, k))
    print('[golden] float32 render vs float64 render on the card: ' + '; '.join(
        f"{k} {golden_err[k]['float32_vs_float64']:.3e}" for k in MAPS), flush=True)
    _check(golden_err['image']['fused'] <= RENDER_TOL,
           f"golden image: kernel render {golden_err['image']['fused']:.3e}")
    _check(golden_err['image']['float32'] <= F32_GOLDEN_TOL,
           f"golden image: float32 render {golden_err['image']['float32']:.3e}")

    # 4. flyby -----------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = render_video_frames(BUNDLE, tmp, n_frames=3, resolution=256,
                                    device='cuda')
        flyby_s = time.perf_counter() - t0
        _check(len(paths) == 3 and all(os.path.getsize(p) > 0 for p in paths),
               'flyby frames missing')
    print(f'[flyby] 3 frames at 256x256: {flyby_s:.2f} s', flush=True)

    fine = kernel_rows['fine']
    kernels = [{
        'name': 'fused_mlp_fwd', 'route': 'cuda',
        'source': 'sunerf_tpu_torch/csrc/fused_mlp_fwd.cu',
        'replaces': 'sunerf_tpu/ops/pallas/fused_mlp.py:343',
        'launches': launches,
        'max_abs_err': max(r['max_abs_err'] for r in kernel_rows.values()),
        'max_rel_err': max(r['max_rel_err'] for r in kernel_rows.values()),
        'ms': fine['ms'], 'plain_ms': fine['plain_ms'], 'bound_ms': fine['bound_ms'],
        'bound_by': 'operations', 'library_ms': None,
        'shapes': kernel_rows, 'render_256_ms': render_ms,
        'render_256_float32_ms': f32_render_ms, 'render_256_err': render_err,
        'render_256_profile': breakdown,
        'golden_err': golden_err,
    }]
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
