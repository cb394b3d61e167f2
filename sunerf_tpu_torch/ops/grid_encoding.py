"""Learned feature-grid encodings (sunerf_tpu/ops/grid_encoding.py).

Dense tables: per level a [G, G, G, F] float32 table with axis order
(y, z, x, f), the JAX package's layout, so bundles load with no transpose:

    feats[n, f] = sum over the 8 cell corners of wx * wy * wz * T[iy, iz, ix, f]

with u = clip((p / bound + 1) * (G - 1) / 2, 0, G - 1) per axis, the lower
corner lo = clip(floor(u), 0, G - 2) and the weights 1 - (u - lo) and
u - lo. On a GPU this is an 8-corner gather; the JAX package's one-hot
contraction is a TPU workaround for slow gathers and is not copied. At
u = G - 1 exactly the lower corner is G - 2 with weight 0 and the upper
G - 1 with weight 1, so no index leaves the table.

The fused kernels' grid branch (csrc/fused_mlp_common.cuh grid_feature)
computes the same features with the same float32 roundings: every product
and sum is rounded on its own, in the corner order of `_corners`, so the
kernel and `grid_encode` agree bit for bit for the same inputs.

TensoRF-style VM levels (vm_encode) and their HexPlane time extension
(vm_encode_time) are plain PyTorch as well: bilinear plane taps times
linear line (or bilinear time-plane) taps per axis orientation, as the JAX
package's gather oracles compute them. No fused kernel takes them; configs
with grid_rank > 0 run the float32 field.
"""
from __future__ import annotations

import torch


def grid_table_init(generator: torch.Generator, grid_size: int, features: int,
                    scale: float = 1e-4, device='cuda') -> torch.Tensor:
    """[G, G, G, F] float32 table, axis order (y, z, x, f), U(-scale, scale)
    as in instant-NGP, drawn from `generator`."""
    u = torch.rand((grid_size, grid_size, grid_size, features),
                   generator=generator, device=generator.device)
    return (u * (2.0 * scale) - scale).to(device)


def _cell(points: torch.Tensor, grid_size: int, bound: float):
    """(lo [N, 3] int64, frac [N, 3] f32) of the first three point columns:
    the lower cell corner per axis and the offset from it."""
    p = points[:, :3]
    b = torch.full((3,), bound, dtype=p.dtype, device=p.device)
    u = ((p / b + 1.0) * (0.5 * (grid_size - 1))).clamp(0.0, float(grid_size - 1))
    lo = torch.floor(u).clamp(0, grid_size - 2)
    return lo.long(), u - lo


def _corners(lo: torch.Tensor, frac: torch.Tensor, grid_size: int):
    """The 8 (flat table row [N], weight [N]) pairs of trilinear
    interpolation, in the order (dx, dy, dz) = 000, 001, 010, ..., 111; the
    weight is (wx * wy) * wz and the row (iy * G + iz) * G + ix."""
    g = grid_size
    out = []
    for dx in (0, 1):
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        for dy in (0, 1):
            wxy = wx * (frac[:, 1] if dy else 1.0 - frac[:, 1])
            for dz in (0, 1):
                w = wxy * (frac[:, 2] if dz else 1.0 - frac[:, 2])
                row = ((lo[:, 1] + dy) * g + lo[:, 2] + dz) * g + lo[:, 0] + dx
                out.append((row, w))
    return out


def grid_encode(table: torch.Tensor, points: torch.Tensor,
                bound: float = 2.0) -> torch.Tensor:
    """[N, F] trilinear features of a dense [G, G, G, F] table (axis order
    y, z, x, f) at the first three columns of [N, >=3] points;
    differentiable in the table (and, through the weights, in the points).
    Points outside [-bound, bound]^3 clamp to the boundary value."""
    grid_size, features = table.shape[0], table.shape[-1]
    rows = table.reshape(-1, features)
    lo, frac = _cell(points, grid_size, bound)
    out = torch.zeros((points.shape[0], features), dtype=table.dtype,
                      device=table.device)
    for row, w in _corners(lo, frac, grid_size):
        out = out + w[:, None] * rows[row]
    return out


def grid_encode_table_grad(points: torch.Tensor, dfeat: torch.Tensor,
                           grid_size: int, bound: float = 2.0) -> torch.Tensor:
    """The table cotangent of grid_encode: [G, G, G, F] with
    d_table[corner] += weight * dfeat[n] over every point and corner
    (index_add_, float32)."""
    features = dfeat.shape[1]
    lo, frac = _cell(points, grid_size, bound)
    out = torch.zeros((grid_size ** 3, features), dtype=dfeat.dtype,
                      device=dfeat.device)
    for row, w in _corners(lo, frac, grid_size):
        out.index_add_(0, row, w[:, None] * dfeat)
    return out.reshape(grid_size, grid_size, grid_size, features)


def table_tv(params: dict) -> torch.Tensor:
    """Mean squared finite difference over every feature-grid table of the
    {'coarse': {...}, 'fine': {...}} params (keys starting with 'grid_'),
    averaged over the spatial axes and the tables
    (sunerf_tpu/train/objective.py table_tv). Dense tables [G, G, G, F]
    difference along axes 0-2, VM planes [3, G, G, R] and time planes
    [3, G, T, R] along axes 1-2, VM lines [3, G, R] along axis 1."""
    total, n = None, 0
    for sub in params.values():
        if not isinstance(sub, dict):
            continue
        for k, t in sub.items():
            if not k.startswith('grid_'):
                continue
            if k.startswith('grid_planes_') or k.startswith('grid_tplanes_'):
                axes = (1, 2)
            elif k.startswith('grid_lines_'):
                axes = (1,)
            else:
                axes = (0, 1, 2)
            tv = sum(torch.mean(torch.diff(t, dim=a) ** 2) for a in axes) / len(axes)
            total = tv if total is None else total + tv
            n += 1
    if not n:
        return torch.zeros(())
    return total / n


# ------------------------------------------------ VM and VM-time (HexPlane)

# per orientation: (plane axis a, plane axis b, line axis c) as coordinate
# columns (x=0, y=1, z=2); planes are row-major [a, b, r]
_VM_AXES = ((1, 2, 0), (2, 0, 1), (0, 1, 2))


def vm_init(generator: torch.Generator, grid_size: int, rank: int,
            scale: float = 0.1, device='cuda'):
    """(planes [3, G, G, R], lines [3, G, R]), N(0, scale) (TensoRF's
    recipe: both factors of a product need O(0.1) magnitude)."""
    gen = dict(generator=generator, device=generator.device)
    planes = scale * torch.randn((3, grid_size, grid_size, rank), **gen)
    lines = scale * torch.randn((3, grid_size, rank), **gen)
    return planes.to(device), lines.to(device)


def vm_time_init(generator: torch.Generator, grid_size: int, time_size: int,
                 rank: int, scale: float = 0.1, device='cuda'):
    """(planes [3, G, G, R], tplanes [3, G, T, R]), N(0, scale)."""
    gen = dict(generator=generator, device=generator.device)
    planes = scale * torch.randn((3, grid_size, grid_size, rank), **gen)
    tplanes = scale * torch.randn((3, grid_size, time_size, rank), **gen)
    return planes.to(device), tplanes.to(device)


def _bilinear(plane: torch.Tensor, i0, fi, j0, fj) -> torch.Tensor:
    """[N, R] bilinear taps of a [I, J, R] plane at cells (i0, j0) with
    offsets (fi, fj)."""
    out = 0.0
    for di in (0, 1):
        for dj in (0, 1):
            w = (fi if di else 1.0 - fi) * (fj if dj else 1.0 - fj)
            out = out + w[:, None] * plane[i0 + di, j0 + dj]
    return out


def vm_encode(planes: torch.Tensor, lines: torch.Tensor, points: torch.Tensor,
              bound: float = 2.0) -> torch.Tensor:
    """[N, 3R] VM features: per orientation (a, b | c), bilinear plane taps
    times linear line taps (vm_init layout)."""
    grid_size = planes.shape[1]
    lo, frac = _cell(points, grid_size, bound)
    outs = []
    for o, (a, b, c) in enumerate(_VM_AXES):
        p = _bilinear(planes[o], lo[:, a], frac[:, a], lo[:, b], frac[:, b])
        line = ((1.0 - frac[:, c])[:, None] * lines[o, lo[:, c]]
                + frac[:, c][:, None] * lines[o, lo[:, c] + 1])
        outs.append(p * line)
    return torch.cat(outs, dim=-1)


def vm_encode_time(planes: torch.Tensor, tplanes: torch.Tensor,
                   points: torch.Tensor, bound: float = 2.0,
                   t_range: tuple = (0.0, 1.0)) -> torch.Tensor:
    """[N, 3R] HexPlane features of [N, 4] (x, y, z, t) points: per
    orientation, bilinear spatial-plane taps times bilinear (axis c, time)
    plane taps; t_range maps onto the T time rows, clamped."""
    grid_size, time_size = planes.shape[1], tplanes.shape[2]
    lo, frac = _cell(points, grid_size, bound)
    t0, t1 = float(t_range[0]), float(t_range[1])
    ut = ((points[:, 3] - t0) / max(t1 - t0, 1e-12) * (time_size - 1)).clamp(
        0.0, float(time_size - 1))
    tlo = torch.floor(ut).clamp(0, max(time_size - 2, 0))
    tfrac = ut - tlo
    tlo = tlo.long()
    outs = []
    for o, (a, b, c) in enumerate(_VM_AXES):
        p = _bilinear(planes[o], lo[:, a], frac[:, a], lo[:, b], frac[:, b])
        q = 0.0
        for dc in (0, 1):
            for dt in (0, 1):
                ti = torch.clamp(tlo + dt, max=time_size - 1)
                w = ((frac[:, c] if dc else 1.0 - frac[:, c])
                     * (tfrac if dt else 1.0 - tfrac))
                q = q + w[:, None] * tplanes[o, lo[:, c] + dc, ti]
        outs.append(p * q)
    return torch.cat(outs, dim=-1)
