"""The grid-encode probe kernels of the JAX package's A/B scripts, ported:

  P1 make_tap_encode (scripts/probe_grid_taps.py)     -> csrc/grid_tap_encode.cu
     trilinear features [N, F] of a packed [G^3 / P, 128] f32 table by 8
     table taps per point (`tap_encode`)
  P2 make_encode (scripts/probe_grid_hatbuild.py)     -> csrc/grid_hat_encode.cu
     the (y, z) hat weights wyz [N, G^2] of each point, then wyz @ table
     [G^2, G F] with bf16 operands and f32 sums (`hat_encode`), the weights
     built one of three ways: 'iota', 'expand', 'inkernel'

Both take the scripts' coordinates, u = clip((p + bound) * 0.5 (G - 1) /
bound, 0, G - 1) per axis, not ops/grid_encoding.py's (p / bound + 1) *
0.5 (G - 1): the two agree to rounding. Tables keep the axis order (y, z, x,
f) of the JAX package.

Each wrapper launches its kernel for CUDA tensors (or raises) and counts
the launch in TAP_LAUNCHES / HAT_LAUNCHES; for CPU tensors it runs the
plain PyTorch version (`tap_encode_reference`, `hat_encode_reference`),
which repeats the kernel's arithmetic, and counts nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from sunerf_tpu_torch.ops import build

TAP_LAUNCHES = 0   # P1, grid_tap_encode
HAT_LAUNCHES = 0   # P2, grid_hat_encode (every variant)
HAT_VARIANTS = ('iota', 'expand', 'inkernel')


def pack_table(table4):
    """[G, G, G, F] (axis order y, z, x, f) -> [G^3 // P, 128] with
    P = 128 // F consecutive rows per row (the TPU's 128-lane packing; the
    same bytes as [G^3, F] row-major)."""
    g, f = table4.shape[0], table4.shape[-1]
    p = 128 // f
    return table4.reshape(g * g * g // p, p * f)


def expansion_matrices(G):
    """The 0/1 matrices that spread per-axis hat rows over the y*G+z
    columns: E1[y, y*G+z] = 1 and E2[z, y*G+z] = 1, float32 numpy."""
    e1 = np.zeros((G, G * G), np.float32)   # wy over y*G+z columns
    e2 = np.zeros((G, G * G), np.float32)   # wz over y*G+z columns
    for y in range(G):
        for z in range(G):
            e1[y, y * G + z] = 1.0
            e2[z, y * G + z] = 1.0
    return e1, e2


def _coords(points: torch.Tensor, grid_size: int, bound: float) -> torch.Tensor:
    """Continuous cell coordinates [N, 3], clamped to [0, G - 1]."""
    scale = 0.5 * (grid_size - 1) / bound
    return ((points + bound) * scale).clamp(0.0, float(grid_size - 1))


def _hat(u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, 1] coordinates x [K] cell indices -> [N, K] trilinear hats."""
    return (1.0 - (u - idx).abs()).clamp_min(0.0)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(a) @ bf16(b) with float32 sums (the products are exact in f32)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def tap_encode_reference(packed_table: torch.Tensor, points: torch.Tensor,
                         grid_size: int, bound: float) -> torch.Tensor:
    """P1's plain version: [N, F] features of a packed table at [N, 3]
    points, the 8 corners summed in the JAX kernel's (dy, dz, dx) order with
    weights ((fy|1-fy) * (fz|1-fz)) * (fx|1-fx), each op rounded on its own."""
    G = grid_size
    rows = packed_table.reshape(G ** 3, -1)
    u = _coords(points[:, :3], G, bound)
    lo = u.floor().clamp(0.0, float(G - 2))
    fx, fy, fz = (u - lo).unbind(1)
    ix, iy, iz = lo.long().unbind(1)
    acc = torch.zeros((points.shape[0], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for dy in (0, 1):
        for dz in (0, 1):
            for dx in (0, 1):
                w = ((fy if dy else 1.0 - fy) * (fz if dz else 1.0 - fz)
                     * (fx if dx else 1.0 - fx))
                row = (iy + dy) * (G * G) + (iz + dz) * G + (ix + dx)
                acc = acc + w[:, None] * rows[row]
    return acc


def tap_encode(packed_table: torch.Tensor, points: torch.Tensor,
               grid_size: int, bound: float) -> torch.Tensor:
    """The P1 wrapper: CUDA tensors launch csrc/grid_tap_encode.cu (or
    raise), CPU tensors run `tap_encode_reference`."""
    global TAP_LAUNCHES
    if points.device.type == 'cpu':
        return tap_encode_reference(packed_table, points, grid_size, bound)
    n, dev = points.shape[0], points.device
    features = packed_table.numel() // grid_size ** 3
    build.check_tensor('points', points, (n, 3), torch.float32, dev)
    build.check_tensor('packed_table', packed_table, packed_table.shape, torch.float32, dev)
    if grid_size < 2 or features * grid_size ** 3 != packed_table.numel():
        raise ValueError(f'packed_table of {packed_table.numel()} elements is no '
                         f'[{grid_size}^3, F] table')
    out = torch.empty((n, features), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    scale = 0.5 * (grid_size - 1) / bound
    build.launch('grid_tap_encode', build.signature(3, 3, 2), dev,
                 points.data_ptr(), packed_table.data_ptr(), out.data_ptr(),
                 n, grid_size, features, bound, scale)
    TAP_LAUNCHES += 1
    return out


def hat_encode_reference(table: torch.Tensor, points: torch.Tensor, grid_size: int,
                         bound: float, variant: str = 'iota', e1=None,
                         e2=None) -> torch.Tensor:
    """P2's plain version: [N, G F] = wyz @ table, with bf16 operands and f32
    sums, where wyz [N, G^2] holds the (y, z) hat weights of each point:
      'iota'      bf16(hat(uy - y) * hat(uz - z)), the product in f32;
      'expand'    bf16((bf16(wy) @ E1) * (bf16(wz) @ E2)) for the given
                  E1, E2 [G, G^2] (wy, wz the per-axis hat rows [N, G]);
      'inkernel'  'expand' with the fixed `expansion_matrices`, which the
                  TPU kernel builds from index comparisons."""
    if variant not in HAT_VARIANTS:
        raise ValueError(f'variant must be one of {HAT_VARIANTS}, got {variant!r}')
    G, dev = grid_size, table.device
    u = _coords(points[:, :3], G, bound)
    uy, uz = u[:, 1:2], u[:, 2:3]
    if variant == 'iota':
        j = torch.arange(G * G, device=dev)
        wyz = _hat(uy, (j // G).float()) * _hat(uz, (j % G).float())
    else:
        if variant == 'inkernel':
            e1, e2 = (torch.from_numpy(e).to(dev) for e in expansion_matrices(G))
        g = torch.arange(G, device=dev).float()
        wyz = _mm(_hat(uy, g), e1) * _mm(_hat(uz, g), e2)
    return _mm(wyz, table)


def hat_encode(table: torch.Tensor, points: torch.Tensor, grid_size: int,
               bound: float, variant: str = 'iota', e1=None, e2=None) -> torch.Tensor:
    """The P2 wrapper: CUDA tensors launch csrc/grid_hat_encode.cu (or
    raise), CPU tensors run `hat_encode_reference`. table [G^2, G F] bf16
    with G F a multiple of 8, points [N, 3] f32; e1, e2 [G, G^2] bf16 for
    'expand' only."""
    global HAT_LAUNCHES
    if variant not in HAT_VARIANTS:
        raise ValueError(f'variant must be one of {HAT_VARIANTS}, got {variant!r}')
    if points.device.type == 'cpu':
        return hat_encode_reference(table, points, grid_size, bound, variant, e1, e2)
    G, n, dev = grid_size, points.shape[0], points.device
    cols = table.shape[-1]
    build.check_tensor('points', points, (n, 3), torch.float32, dev)
    build.check_tensor('table', table, (G * G, cols), torch.bfloat16, dev)
    if cols % 8 or table.data_ptr() % 16:
        raise ValueError(f'the kernel takes 16-byte aligned tables whose width is a '
                         f'multiple of 8, got width {cols}')
    if variant == 'expand':
        build.check_tensor('e1', e1, (G, G * G), torch.bfloat16, dev)
        build.check_tensor('e2', e2, (G, G * G), torch.bfloat16, dev)
    out = torch.empty((n, cols), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    scale = 0.5 * (G - 1) / bound
    expand = variant == 'expand'
    build.launch('grid_hat_encode', build.signature(5, 4, 2), dev,
                 points.data_ptr(), table.data_ptr(), e1.data_ptr() if expand else None,
                 e2.data_ptr() if expand else None, out.data_ptr(),
                 n, G, cols, HAT_VARIANTS.index(variant), bound, scale)
    HAT_LAUNCHES += 1
    return out

