"""The wide route's kernels (ops/wide_mlp.py) against their plain versions,
and their times beside the plain versions', a library yardstick and the
card's bound, at fields the fused kernels cannot hold.

    python -m sunerf_tpu_torch.scripts.probe_wide [--shapes 8x1024:2 2x640:9 8x512:16]
        [--n-fwd 245760] [--n-bwd 196608] [--paths] [--reps 10] [--device cuda]

A shape is LAYERSxWIDTH:D_OUTPUT, an emission field (d_input 4, 10 bands)
with random weights, points in the sampling shell and a dy, all from a seed.
For each: the wide K0 (through fused_mlp_forward without a gradient) against
fused_mlp_reference at --n-fwd points; the wide K1 'int8' (through
fused_mlp_stash_forward) against its plain version, its stash layer by
layer against fused_mlp_stash_layerwise fed the kernel's own sin stash; the
wide K2 (fused_mlp_stash_backward) against fused_mlp_stash_bwd_reference fed
the kernel's stash, twice (the bits), at --n-bwd points. --paths adds K3,
K4, 'lsb' (K6a), 'i8pair' (K6b) and a grid field (K5) at 2x640 through
fused_mlp_forward
under autograd, against the plain versions, K6b's backward alone at scale
groups 8, 40 and 768, and K6b at 8x1024 / d_output 2, N = --n-bwd, the
default group (forward + backward under autograd, and the backward
alone). Times: CUDA events, the median
of --reps calls after 2 (host clock on --device cpu: a CPU number). The
library yardstick of a row is one bf16 torch.matmul per layer product at
the same shapes (K0: the L layers and the head; K2: the chain's and dW's
products; a path: its forward's and backward's products), timed only;
nothing on the route calls it; K6b's dW_h has two more, one bf16 torch.bmm
of the hidden layers' sin^T dz and torch._int_mm of each layer's int8
product over all points. The bound: the
operations at 989 TFLOP/s bf16 dense (K6b's dW_h products at 1979 TOPS
int8 dense) and the bytes at 3.35 TB/s, the larger. main returns {shape: {k0, k1, k2}} (and 'paths'), each with its
errors, ms, plain_ms, library_ms, bound_ms, bound_by and launches by
kernel name.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf
from sunerf_tpu_torch.ops import fused_mlp, wide_mlp

BF16_TFLOPS = 989.0    # H100 SXM dense bf16 tensor-core peak
INT8_TOPS = 1979.0     # H100 SXM dense int8 tensor-core peak
HBM_TBPS = 3.35        # H100 SXM device memory rate
SHAPES = ('8x1024:2', '2x640:9', '8x512:16')
KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')


def parse_shape(s: str) -> tuple:
    layers, rest = s.split('x')
    width, d_out = rest.split(':')
    return int(layers), int(width), int(d_out)


def setup(layers: int, width: int, d_out: int, n: int, device, seed: int, **extra):
    """A field of these widths (emission_config, any d_output and `extra`
    fields), its random parameters, points in the shell and a dy."""
    cfg = dataclasses.replace(emission_config(n_layers=layers, d_filter=width, **extra),
                              d_output=d_out)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = init_nerf(gen, cfg, device)
    pts = torch.rand(n, 4, generator=gen, device=device) * 2.6 - 1.3
    pts[:, 3] = torch.rand(n, generator=gen, device=device)
    dy = torch.randn(n, d_out, generator=gen, device=device)
    return cfg, p, pts, dy


def timed_ms(fn, device, reps: int) -> float:
    """Median ms of `reps` calls of fn after 2: CUDA events on the card,
    the host clock on the CPU."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if device.type == 'cuda':
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# stash bytes a hidden unit of a point, by format: bf16 sin + int8 cos;
# one bf16 stream; int8 sin + int8 cos
STASH_BYTES = {'int8': 3, 'lsb': 2, 'i8pair': 2}


def bound(flops: float, nbytes: float, i8_ops: float = 0.0) -> tuple:
    """(least ms on the card, 'operations' or 'bytes'): flops on the bf16
    tensor cores, i8_ops on the int8 ones."""
    t_ops = (flops / (BF16_TFLOPS * 1e12) + i8_ops / (INT8_TOPS * 1e12)) * 1e3
    t_bytes = nbytes / (HBM_TBPS * 1e12) * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def fwd_flops(cfg, n: int) -> float:
    h = cfg.d_filter
    return 2.0 * n * h * (cfg.d_encoded + (cfg.n_layers - 1) * h + cfg.d_output)


def bwd_flops(cfg, n: int) -> float:
    """dW_h and dh of each hidden layer, dW_in, dW_out and the first dh."""
    h = cfg.d_filter
    return float(n) * (4 * (cfg.n_layers - 1) * h * h + 2 * cfg.d_encoded * h
                       + 4 * cfg.d_output * h)


def param_bytes(cfg) -> int:
    h = cfg.d_filter
    return 4 * ((cfg.d_encoded + 1) * h + (cfg.n_layers - 1) * (h + 1) * h
                + (h + 1) * cfg.d_output)


def err_stats(ref: torch.Tensor, got: torch.Tensor, tol: float = 2e-2,
              max_tol: float = 1e-1) -> dict:
    """Per-point error of got against ref [N, d] as fractions of max|ref|:
    max, p99.99, RMS over RMS, and the points past tol and past max_tol."""
    ref, got = ref.double(), got.double()
    d = (got - ref).abs().amax(dim=1)
    m = float(ref.abs().max())
    q = torch.quantile(d.cpu(), 0.9999)
    return dict(max_abs_err=float(d.max()), max_rel_err=float(d.max()) / m,
                p9999_rel_err=float(q) / m,
                rms_rel_err=float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()),
                points_over_tol=int((d > tol * m).sum()),
                points_over_max=int((d > max_tol * m).sum()))


def grad_err(ref: dict, got: dict) -> dict:
    """Per gradient: max |got - ref| over max|ref|, and RMS over RMS."""
    out = {}
    for k in ref:
        r, g = ref[k].double(), got[k].double()
        d = (g - r).abs()
        out[k] = dict(max_abs_err=float(d.max()),
                      max_rel_err=float(d.max() / r.abs().max().clamp_min(1e-30)),
                      rms_rel_err=float((g - r).pow(2).mean().sqrt()
                                        / r.pow(2).mean().sqrt().clamp_min(1e-30)))
    return out


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units of the bf16 ulp of the larger magnitude."""
    af, bf = a.float(), b.float()
    m = torch.maximum(af.abs(), bf.abs()).clamp_min(2.0 ** -126)
    return (af - bf).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)


def launches(fn, grid: bool = False) -> dict:
    """fn's launches by the wide libraries' kernels (on the card), with
    grid the fused backward's grid kernels (its scatter spreads the wide
    route's grid cotangent), and the wrappers' counters; on the CPU nothing
    launches."""
    if not torch.cuda.is_available():
        fn()
        return {}
    libs = ['wide_mlp_fwd', 'wide_mlp_bwd'] + (['fused_mlp_stash_bwd'] if grid else [])
    names = {lib: fused_mlp.kernel_launches(lib) for lib in libs}
    counters = ('WIDE_LAUNCHES', 'WIDE_STASH_FWD_LAUNCHES', 'WIDE_STASH_BWD_LAUNCHES',
                'WIDE_RECOMPUTE_BWD_LAUNCHES')
    before = {c: getattr(wide_mlp, c) for c in counters}
    fn()
    torch.cuda.synchronize()
    out = {c: getattr(wide_mlp, c) - before[c] for c in counters
           if getattr(wide_mlp, c) != before[c]}
    for lib, b in names.items():
        after = fused_mlp.kernel_launches(lib)
        out.update({k: after[k] - b[k] for k in b if after[k] != b[k]})
    return out


def _matmul_ms(shapes, device, reps) -> float:
    """The summed ms of one bf16 torch.matmul [m, k] x [k, n] per shape."""
    total = 0.0
    for m, k, n in shapes:
        a = torch.randn(m, k, device=device, dtype=torch.bfloat16)
        b = torch.randn(k, n, device=device, dtype=torch.bfloat16)
        total += timed_ms(lambda: torch.matmul(a, b), device, reps)
        del a, b
    return total


def layer_products(cfg, n: int, dpts: bool = False, recompute: bool = False) -> list:
    """The (m, k, n) of each layer product of a forward and backward: the
    forward's L layers and head (twice where the backward recomputes it),
    the chain's dh, the dW products and, with dpts, K3's denc."""
    h, L, d = cfg.d_filter, cfg.n_layers, cfg.d_output
    e = -(-cfg.d_encoded // 16) * 16
    fwd = [(n, e, h)] + [(n, h, h)] * (L - 1) + [(n, h, d)]
    bwd = [(n, d, h), (h, n, d)] + [(n, h, h), (h, n, h)] * (L - 1) + [(e, n, h)]
    return fwd * (2 if recompute else 1) + bwd + ([(n, h, cfg.d_encoded)] if dpts else [])


def dw_h_yardsticks(cfg, hs: torch.Tensor, reps: int) -> dict:
    """K6b's dW_h yardsticks at the stash's shapes, timed only: one bf16
    torch.bmm of the hidden layers' sin^T dz ([L-1, H, n] x [L-1, n, H], the
    stash's sin8 as bf16, dz normal) and torch._int_mm of each layer's int8
    product over all points ([H, n] x [n, H], dz8 uniform in [-127, 127]),
    summed over the layers."""
    n, L, h = hs.shape[0], cfg.n_layers, cfg.d_filter
    dev = hs.device
    gen = torch.Generator(device=dev).manual_seed(7)
    s8 = hs.view(n, L, 2, h)[:, :L - 1, 0].permute(1, 2, 0).contiguous()
    sb = s8.to(torch.bfloat16)
    dz = torch.randn((L - 1, n, h), generator=gen, device=dev).to(torch.bfloat16)
    out = {'bmm_ms': timed_ms(lambda: torch.bmm(sb, dz), dev, reps)}
    del sb, dz
    dz8 = torch.randint(-127, 128, (L - 1, n, h), generator=gen, device=dev, dtype=torch.int8)
    out['int_mm_ms'] = timed_ms(lambda: [torch._int_mm(s8[j], dz8[j]) for j in range(L - 1)],
                                dev, reps)
    return out


def k0_row(cfg, p, pts, reps: int) -> dict:
    """The wide K0 against fused_mlp_reference, its times and bound."""
    dev, n, h = pts.device, pts.shape[0], cfg.d_filter
    with torch.no_grad():
        out = fused_mlp.fused_mlp_forward(cfg, p, pts)
        ref = fused_mlp.fused_mlp_reference(cfg, p, pts)
        row = err_stats(ref, out)
        row['finite'] = bool(torch.isfinite(out).all())
        if dev.type == 'cuda':
            # the f32 order's own floor: the plain version on the CPU
            # against the card's, on the first 2,048 points
            sub = pts[:2048]
            row['plain_cpu_vs_card'] = err_stats(ref[:2048], fused_mlp.fused_mlp_reference(
                cfg, {k: v.cpu() for k, v in p.items()}, sub.cpu()).to(dev))
        del out, ref
        row['launches'] = launches(lambda: fused_mlp.fused_mlp_forward(cfg, p, pts))
        row['ms'] = timed_ms(lambda: fused_mlp.fused_mlp_forward(cfg, p, pts), dev, reps)
        row['plain_ms'] = timed_ms(lambda: fused_mlp.fused_mlp_reference(cfg, p, pts), dev,
                                   max(2, reps // 4))
    e = -(-cfg.d_encoded // 16) * 16
    row['library_ms'] = _matmul_ms([(n, e, h)] + [(n, h, h)] * (cfg.n_layers - 1)
                                   + [(n, h, cfg.d_output)], dev, reps)
    row['bound_ms'], row['bound_by'] = bound(
        fwd_flops(cfg, n), n * 4 * (cfg.d_input + cfg.d_output) + param_bytes(cfg))
    return row


def k12_rows(cfg, p, pts, dy, reps: int) -> tuple:
    """The wide K1 ('int8') and K2 against their plain versions: K1's out,
    its stash layer by layer; K2's gradients fed K1's stash, twice."""
    dev, n, h, L = pts.device, pts.shape[0], cfg.d_filter, cfg.n_layers
    out, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts)
    ref_out = fused_mlp.fused_mlp_reference(cfg, p, pts)
    k1 = err_stats(ref_out, out)
    with torch.no_grad():
        k1['vs_k0_max_rel_err'] = err_stats(fused_mlp.fused_mlp_forward(cfg, p, pts),
                                            out)['max_rel_err']
        if dev.type == 'cuda':
            # the f32 order's own floor on this field, as k0_row's
            k1['plain_cpu_vs_card'] = err_stats(ref_out[:2048], fused_mlp.fused_mlp_reference(
                cfg, {k: v.cpu() for k, v in p.items()}, pts[:2048].cpu()).to(dev))
    del ref_out
    lw_hs, lw_cs = fused_mlp.fused_mlp_stash_layerwise(cfg, p, pts, hs)
    k1['hs_within_1ulp_layerwise'] = float((bf16_ulps(lw_hs, hs) <= 1).float().mean())
    k1['cs_max_diff_layerwise'] = int((cs.int() - lw_cs.int()).abs().max())
    del lw_hs, lw_cs
    k1['launches'] = launches(lambda: fused_mlp.fused_mlp_stash_forward(cfg, p, pts))
    k1['ms'] = timed_ms(lambda: fused_mlp.fused_mlp_stash_forward(cfg, p, pts), dev, reps)
    k1['plain_ms'] = timed_ms(lambda: fused_mlp.fused_mlp_stash_reference(cfg, p, pts), dev,
                              max(2, reps // 4))
    e = -(-cfg.d_encoded // 16) * 16
    k1['library_ms'] = _matmul_ms([(n, e, h)] + [(n, h, h)] * (L - 1) + [(n, h, cfg.d_output)],
                                  dev, reps)
    io = n * 4 * (cfg.d_input + cfg.d_output)
    k1['bound_ms'], k1['bound_by'] = bound(fwd_flops(cfg, n),
                                           io + n * L * h * STASH_BYTES['int8'] + param_bytes(cfg))

    grads = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs)
    again = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs)
    ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs)
    k2 = dict(grads=grad_err(ref, grads),
              bit_identical=all(torch.equal(grads[k], again[k]) for k in KEYS),
              finite=all(bool(torch.isfinite(grads[k]).all()) for k in KEYS))
    k2['max_rel_err'] = max(g['max_rel_err'] for g in k2['grads'].values())
    k2['max_abs_err'] = max(g['max_abs_err'] for g in k2['grads'].values())
    del grads, again, ref
    k2['launches'] = launches(lambda: fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs))
    k2['ms'] = timed_ms(lambda: fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs),
                        dev, reps)
    k2['plain_ms'] = timed_ms(
        lambda: fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs), dev,
        max(2, reps // 4))
    # the chain's dh and each dW as one matmul each
    k2['library_ms'] = _matmul_ms(
        [(n, cfg.d_output, h), (h, n, cfg.d_output)] + [(n, h, h), (h, n, h)] * (L - 1)
        + [(e, n, h)], dev, reps)
    k2['bound_ms'], k2['bound_by'] = bound(bwd_flops(cfg, n),
                                           io + n * L * h * STASH_BYTES['int8'] + 2 * param_bytes(cfg))
    return k1, k2


def _autograd(cfg, p, pts, dy, **knobs) -> dict:
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    x = pts.clone().requires_grad_()
    fused_mlp.fused_mlp_forward(cfg, leaves, x, **knobs).backward(dy)
    grads = {k: v.grad for k, v in leaves.items()}
    if x.grad is not None:
        grads['dpts'] = x.grad
    return grads


def path_rows(n: int, device, reps: int) -> dict:
    """K3 (the point cotangent), K4 (stash=False), K6a ('lsb'), K6b
    ('i8pair', scale groups of 768) and K5 (a two-level grid field, no point
    cotangent) at 2x640 under autograd,
    against the plain versions; launches by name, gradients twice; the
    forward + backward's ms beside the plain versions' and the bound of its
    products (and its stash bytes)."""
    rows = {}
    cfg, p, pts, dy = setup(2, 640, 2, n, device, seed=640)
    gcfg, gp, _, _ = setup(2, 640, 2, n, device, seed=641, grid_sizes=(16, 32),
                           grid_features=4)
    for name, c, q, knobs, compute_dpts in (
            ('K3', cfg, p, dict(), True), ('K4', cfg, p, dict(stash=False), True),
            ('K6a', cfg, p, dict(stash_format='lsb'), True),
            ('K6b', cfg, p, dict(stash_format='i8pair'), True),
            ('K5', gcfg, gp, dict(compute_dpts=False), False)):
        got = _autograd(c, q, pts, dy, **knobs)
        again = _autograd(c, q, pts, dy, **knobs)
        fmt = knobs.get('stash_format', 'int8')

        def plain(c=c, q=q, fmt=fmt, compute_dpts=compute_dpts, recompute=name == 'K4'):
            if recompute:
                fused_mlp.fused_mlp_reference(c, q, pts)
                return fused_mlp.fused_mlp_recompute_bwd_reference(c, q, pts, dy)
            _, hs, cs = fused_mlp.fused_mlp_stash_reference(c, q, pts, fmt)
            return fused_mlp.fused_mlp_stash_bwd_reference(c, q, pts, dy, hs, cs, fmt,
                                                           compute_dpts)
        ref = plain()
        row = dict(grads=grad_err(ref, got), keys_match=set(got) == set(ref),
                   bit_identical=all(torch.equal(got[k], again[k]) for k in got),
                   finite=all(bool(torch.isfinite(v).all()) for v in got.values()))
        row['max_rel_err'] = max(g['max_rel_err'] for g in row['grads'].values())
        row['max_abs_err'] = max(g['max_abs_err'] for g in row['grads'].values())
        row['launches'] = launches(lambda: _autograd(c, q, pts, dy, **knobs), name == 'K5')
        row['ms'] = timed_ms(lambda: _autograd(c, q, pts, dy, **knobs), device, reps)
        row['plain_ms'] = timed_ms(plain, device, reps)
        flops = fwd_flops(c, n) * (2 if name == 'K4' else 1) + bwd_flops(c, n)
        # 'i8pair' takes dW_h's products on the int8 tensor cores
        i8_ops = 2.0 * n * (c.n_layers - 1) * c.d_filter ** 2 if fmt == 'i8pair' else 0.0
        stash = 0 if name == 'K4' else 2 * n * c.n_layers * c.d_filter * STASH_BYTES[fmt]
        row['bound_ms'], row['bound_by'] = bound(
            flops - i8_ops, n * 4 * (2 * c.d_input + 2 * c.d_output) + 2 * param_bytes(c) + stash,
            i8_ops)
        row['library_ms'] = _matmul_ms(layer_products(c, n, compute_dpts, name == 'K4'), device,
                                       reps)
        if fmt == 'i8pair' and device.type == 'cuda':
            _, hs, _ = fused_mlp.fused_mlp_stash_forward(c, q, pts, fmt)
            row['dw_h_library'] = dw_h_yardsticks(c, hs, reps)
            del hs
        rows[name] = row
    return rows


def i8pair_wide_row(n: int, device, reps: int) -> dict:
    """Wide K6b ('i8pair') at the converted reference's width, 8x1024 /
    d_output 2 at n points and the default scale group: forward + backward
    (dpts included) under autograd against the plain version, twice (the
    bits), its launches by kernel name, ms beside the plain version's, the
    bound (dW_h at the int8 rate) and the yardsticks (layer_products,
    dw_h_yardsticks); then the backward alone fed the kernel's own stash
    (bwd_ms, bwd_plain_ms)."""
    layers, width, d_out, group = 8, 1024, 2, fused_mlp.STASH_BWD_TILE
    cfg, p, pts, dy = setup(layers, width, d_out, n, device, seed=1024 + group)
    knobs = dict(stash_format='i8pair', stash_bwd_tile=group)
    got = _autograd(cfg, p, pts, dy, **knobs)
    again = _autograd(cfg, p, pts, dy, **knobs)

    def plain():
        _, hs, cs = fused_mlp.fused_mlp_stash_reference(cfg, p, pts, 'i8pair')
        return fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs, 'i8pair', True,
                                                       group)
    ref = plain()
    row = dict(grads=grad_err(ref, got), keys_match=set(got) == set(ref),
               bit_identical=all(torch.equal(got[k], again[k]) for k in got),
               finite=all(bool(torch.isfinite(v).all()) for v in got.values()))
    row['max_rel_err'] = max(g['max_rel_err'] for g in row['grads'].values())
    row['max_abs_err'] = max(g['max_abs_err'] for g in row['grads'].values())
    del got, again, ref
    row['launches'] = launches(lambda: _autograd(cfg, p, pts, dy, **knobs))
    row['ms'] = timed_ms(lambda: _autograd(cfg, p, pts, dy, **knobs), device, reps)
    row['plain_ms'] = timed_ms(plain, device, max(2, reps // 4))
    i8_ops = 2.0 * n * (layers - 1) * width ** 2
    row['bound_ms'], row['bound_by'] = bound(
        fwd_flops(cfg, n) + bwd_flops(cfg, n) - i8_ops,
        n * 4 * (2 * cfg.d_input + 2 * d_out) + 2 * param_bytes(cfg)
        + 2 * n * layers * width * STASH_BYTES['i8pair'], i8_ops)
    row['library_ms'] = _matmul_ms(layer_products(cfg, n, True), device, reps)
    _, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts, 'i8pair')

    def bwd():
        return fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs, 'i8pair', True, group)
    row['bwd_ms'] = timed_ms(bwd, device, reps)
    row['bwd_plain_ms'] = timed_ms(
        lambda: fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs, 'i8pair', True,
                                                        group), device, max(2, reps // 4))
    if device.type == 'cuda':
        row['dw_h_library'] = dw_h_yardsticks(cfg, hs, reps)
    # dW_h alone: its int8 operations and its bytes (sin8 and dz read once)
    row['dw_h_bound_ms'], row['dw_h_bound_by'] = bound(
        0.0, (layers - 1) * n * width * 3.0, i8_ops)
    return row


def i8pair_group_rows(n: int, device, reps: int, groups=(8, 40, 768)) -> dict:
    """Wide K6b ('i8pair') at scale groups that are no multiple of 32 and at
    the default, on a 2x640 / d_output 2 field at n points: its backward (dpts included)
    against the plain version fed the kernel's own stash, twice (the bits),
    its launches by kernel name, ms beside the plain version's."""
    rows = {}
    cfg, p, pts, dy = setup(2, 640, 2, n, device, seed=642)
    _, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts, 'i8pair')
    for group in groups:
        def run(group=group):
            return fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs, 'i8pair', True,
                                                      group)

        def plain(group=group):
            return fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs, 'i8pair',
                                                           True, group)
        got, again, ref = run(), run(), plain()
        row = dict(grads=grad_err(ref, got),
                   bit_identical=all(torch.equal(got[k], again[k]) for k in got),
                   finite=all(bool(torch.isfinite(v).all()) for v in got.values()))
        row['max_rel_err'] = max(g['max_rel_err'] for g in row['grads'].values())
        row['max_abs_err'] = max(g['max_abs_err'] for g in row['grads'].values())
        row['launches'] = launches(run)
        row['ms'] = timed_ms(run, device, reps)
        row['plain_ms'] = timed_ms(plain, device, max(2, reps // 4))
        rows[f'group {group}'] = row
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--shapes', nargs='*', default=list(SHAPES))
    parser.add_argument('--n-fwd', type=int, default=245760)
    parser.add_argument('--n-bwd', type=int, default=196608)
    parser.add_argument('--n-paths', type=int, default=65536)
    parser.add_argument('--paths', action='store_true')
    parser.add_argument('--reps', type=int, default=10)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    rows = {}
    for i, shape in enumerate(args.shapes):
        layers, width, d_out = parse_shape(shape)
        cfg, p, pts, _ = setup(layers, width, d_out, args.n_fwd, device, seed=i)
        row = {'k0': k0_row(cfg, p, pts, args.reps)}
        del pts
        cfg, p, pts, dy = setup(layers, width, d_out, args.n_bwd, device, seed=100 + i)
        row['k1'], row['k2'] = k12_rows(cfg, p, pts, dy, args.reps)
        rows[shape] = row
        del p, pts, dy
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        print(shape, json.dumps(row), flush=True)
    if args.paths:
        rows['paths'] = path_rows(args.n_paths, device, args.reps)
        print('paths', json.dumps(rows['paths']), flush=True)
        rows['i8pair_groups'] = i8pair_group_rows(args.n_paths, device, args.reps)
        print('i8pair_groups', json.dumps(rows['i8pair_groups']), flush=True)
        rows['i8pair_8x1024'] = i8pair_wide_row(args.n_bwd, device, args.reps)
        print('i8pair_8x1024', json.dumps(rows['i8pair_8x1024']), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == '__main__':
    main()
