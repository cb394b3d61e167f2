"""The wide route of the fused field: a field that the fused kernels cannot
hold (d_filter above 512, or d_output outside their heads: 1..8 for the
forward K0, 1..4 where a backward runs; fused_mlp.kernel_route) runs on
kernels with one launch a layer, the activations through device memory
(csrc/wide_mlp.cuh), at any width and any output count. Every bf16 product
is a launch of one warp-specialised GEMM, wide_wgmma_kernel (TMA boxes in
the 128-byte swizzle into a ring, wgmma from shared memory, a persistent
walk over 128 x TN tiles), with the layer's work in its epilogue:

  K0 no-grad forward      -> csrc/wide_mlp_fwd.cu  (fmt 0)
  K1 'int8' stashing fwd  -> the same, the int8 cos8 stash in its epilogue
  K6a 'lsb' stashing fwd  -> the same, the packed sin stash
  K6b 'i8pair' fwd        -> the same, the int8 sin / cos8 pairs
  K4 recompute forward    -> the same, bf16 sin and cos, chunk by chunk
  K2 / K6a / K6b / K4 bwd -> csrc/wide_mlp_bwd.cu: the chain, dW and db
                             products ('i8pair''s dW_h per scale group on
                             int8 wgmma, wide_dw_i8_wgmma_kernel, the
                             groups' maxima from the chain's epilogue), with K3
                             (the point cotangent) and K5 (the grid levels'
                             cotangent, spread over the tables by the fused
                             backward's scatter, csrc/fused_mlp_stash_bwd.cu)

The stashes have the fused kernels' layouts (fused_mlp._stash_shapes), so
the plain versions read them as they read the fused kernels'. The weights
go to the kernels as bf16 copies: the forward's W^T (pack_wide: w_in^T
[H, e_pad], w_h^T, w_out^T [d_out, H]) and the backward's W as stored
(pack_wide_bwd: w_h, w_out [H, o_pad], w_in [E, H]), each made once per
parameter set and cached on the identity and version of its tensors.
The host plans of the kernels are mirrored here and tested on the CPU:
tile_n (a product's N tile), dw_plan (a dW product's ranges of the points),
i8_plan ('i8pair''s dW_h ranges of whole scale groups),
operand_row_bytes (every TMA operand's row stride and base offset in bytes,
multiples of 16), and 'i8pair''s int8 operand builds (i8_build_operands)
and scale groups' maxima (dz_row_maxima, dz_group_maxima). 'i8pair' takes
any scale group (stash_bwd_tile) from 1 to 133,144 points. On a CUDA tensor
a wrapper launches its kernels or raises (there is no fallback); on a CPU
tensor it runs the plain version
(fused_mlp_reference, fused_mlp_stash_reference,
fused_mlp_stash_bwd_reference, fused_mlp_recompute_bwd_reference), which
defines its function."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from sunerf_tpu_torch.models.fields import NeRFConfig
from sunerf_tpu_torch.ops import build
from sunerf_tpu_torch.ops import fused_mlp as fm

# launches so far, one per wrapper call that launched (CUDA tensors)
WIDE_LAUNCHES = 0                # wide K0
WIDE_STASH_FWD_LAUNCHES = 0      # wide K1 / K6a
WIDE_STASH_BWD_LAUNCHES = 0      # wide K2 / K6a (with K3, K5)
WIDE_RECOMPUTE_BWD_LAUNCHES = 0  # wide K4
WIDE_MAX_SPLITS = 16    # dW point ranges at most (csrc/wide_mlp.cuh kMaxSplits)
WIDE_SUM_PARTS = 128    # column-sum row ranges at most (kSumRows)
TILE_M, TILE_K = 128, 64   # a GEMM tile's rows and a ring stage's k (kBM, kBK)
I8_TN = 128             # 'i8pair''s dW_h tiles (kBM x kI8TN)
_FWD_FMT = {'int8': 1, 'lsb': 2, 'i8pair': 3, 'recompute': 4}   # kStash* codes (K0 is 0)
_packs: WeakIdKeyDictionary = WeakIdKeyDictionary()
_packs_bwd: WeakIdKeyDictionary = WeakIdKeyDictionary()


def wide_width(d_filter: int) -> int:
    """The width a field runs at on the wide route: d_filter rounded up to a
    multiple of 16, zero-padded (pad_field): every bf16 row, and the 'int8'
    stash's int8 rows of L H, a multiple of 16 bytes, as a TMA tensor map
    takes them."""
    return -(-d_filter // 16) * 16


def e_pad(config: NeRFConfig) -> int:
    """The encoding's width rounded up to 16: the first layer's K."""
    return -(-config.d_encoded // 16) * 16


def o_pad(d_output: int) -> int:
    """d_output rounded up to 8: the chain's first K."""
    return -(-d_output // 8) * 8


def tile_n(n: int, min_tn: int) -> int:
    """A product's N tile (csrc/wide_mlp.cuh tile_n): from min_tn (the layers
    and the chain 128, an MN-major B 64, else 8) the smallest of 8 .. 128
    that holds n; above 128 columns 256 unless 128 pads n less."""
    if n > 128:
        pad256, pad128 = -(-n // 256) * 256 - n, -(-n // 128) * 128 - n
        return 256 if pad256 <= pad128 else 128
    tn = 8
    while tn < n or tn < min_tn:
        tn *= 2
    return tn


def dw_plan(m: int, n_out: int, points: int, sms: int) -> tuple:
    """A dW product's ranges of the points (csrc/wide_mlp.cuh dw_plan): as
    many as keep every block of the card on one tile, at least 1024 points
    a range, at most WIDE_MAX_SPLITS -> (tn, splits, k_split), k_split a
    multiple of TILE_K. Range s holds points [s k_split, (s+1) k_split)."""
    tn = tile_n(n_out, 64)
    tiles = -(-m // TILE_M) * -(-n_out // tn)
    want = max(1, min(sms // tiles, WIDE_MAX_SPLITS, -(-points // 1024)))
    k_split = -(-(-(-points // want)) // TILE_K) * TILE_K
    return tn, -(-points // k_split), k_split


def i8_tiles(h: int) -> int:
    """'i8pair''s dW_h output tiles of TILE_M x I8_TN."""
    return -(-h // TILE_M) * -(-h // I8_TN)


def i8_plan(h: int, points: int, group: int, sms: int) -> tuple:
    """'i8pair''s dW_h ranges (csrc/wide_mlp.cuh i8_plan): whole scale
    groups, as many as keep every block of the card on one tile (one wave
    of the persistent walk), at least 1024 points a range, at most
    WIDE_MAX_SPLITS -> (splits, k_split), k_split a multiple of group.
    Range s holds points [s k_split, (s+1) k_split)."""
    want = max(1, min(sms // i8_tiles(h), WIDE_MAX_SPLITS, -(-points // 1024)))
    k_split = -(-(-(-points // want)) // group) * group
    return -(-points // k_split), k_split


def _swizzle128(row, byte):
    """csrc/hopper.cuh swizzle128: the byte of (row, byte column) in a box of
    128-byte rows as TMA writes it in the 128-byte swizzle."""
    return row * 128 + (((byte // 16) ^ (row % 8)) % 8) * 16 + byte % 16


def i8_build_operands(box: torch.Tensor, dz_box: torch.Tensor, s0: int, s1: int,
                      scale: float):
    """A mirror of build_a8 and build_b8 (csrc/wide_mlp.cuh) for one segment
    [s0, s1) of a 64-point chunk: box [64 points, 128] int8 (the stash box:
    sin8 of the tile's 128 rows m) and dz_box [64 points, I8_TN] bf16 (dz's
    columns of the tile, zeros past the width as TMA fills them), placed in
    shared memory as TMA writes them (128-byte swizzle; dz in boxes of 64
    columns, 8192 bytes apart) -> the int8 operand buffers A [128 * 64] and
    B [I8_TN * 64] as the 256 threads write them: thread t (warp w, lane l,
    q = l // 4) loads the points 8 j + q (j = 0..7) at the device's byte
    addresses (A: box + 128 q + 16 (w ^ q) + 4 (l % 4) + 1024 j, 4 columns
    m = 16 w + 4 (l % 4) + e; B: boxes + 8192 (ng // 8) + 128 q + 16 ((ng %
    8) ^ q) + 4 (l % 4) + 1024 j, the columns n = 8 ng + 2 (l % 4) + e of
    ng = 2 w + u) and stores their 8 bytes at fused_mlp.i8_operand_index's
    row (m or n), k = 16 (q // 2) + 8 (q % 2) + j, which stands for chunk
    point fused_mlp.i8_point(k); B's bytes are the low bytes of dz * scale +
    I8_ROUND in f32 for points [s0, s1), 0 for the others."""
    t = torch.arange(256)
    w, lane = t // 32, t % 32
    q = (lane // 4).view(256, 1, 1)
    cp = (lane % 4).view(256, 1, 1)
    wq = w.view(256, 1, 1)
    j = torch.arange(8).view(1, 1, 8)
    k = 16 * (q // 2) + 8 * (q % 2) + j
    e = torch.arange(4).view(1, 4, 1)
    pr = torch.arange(64).view(64, 1)
    # shared memory as TMA leaves it
    stored_a = torch.zeros(64 * 128, dtype=torch.uint8)
    stored_a[_swizzle128(pr, torch.arange(128).view(1, 128)).reshape(-1)] = \
        box.view(torch.uint8).reshape(-1)
    col = torch.arange(I8_TN).view(1, I8_TN)
    stored_b = torch.zeros(I8_TN // 64 * 8192, dtype=torch.uint8)
    at_b = (col // 64) * 8192 + _swizzle128(pr, 2 * (col % 64))
    bits = dz_box.to(torch.bfloat16).contiguous().view(torch.int16).to(torch.int32)
    stored_b[at_b.reshape(-1)] = (bits & 0xFF).to(torch.uint8).reshape(-1)
    stored_b[(at_b + 1).reshape(-1)] = ((bits >> 8) & 0xFF).to(torch.uint8).reshape(-1)
    # A: a 32-bit load a point, byte e column m
    a8 = torch.zeros(128 * 64, dtype=torch.uint8)
    m = 16 * wq + 4 * cp + e
    a8[fm.i8_operand_index(128, m, k)] = stored_a[q * 128 + ((wq ^ q) << 4) + 4 * cp + 1024 * j
                                                  + e]
    # B: a 32-bit load a point, its two bf16 columns n and n + 1
    b8 = torch.zeros(I8_TN * 64, dtype=torch.uint8)
    pt = 8 * j + q
    sc = torch.where((pt >= s0) & (pt < s1), torch.tensor(scale, dtype=torch.float32),
                     torch.tensor(0.0))
    for u in range(I8_TN // 64):
        ng = (I8_TN // 64) * wq + u
        src = (ng // 8) * 8192 + q * 128 + (((ng % 8) ^ q) << 4) + 4 * cp + 1024 * j
        for half in range(2):
            lo = stored_b[src + 2 * half].to(torch.int32)
            hi = stored_b[src + 2 * half + 1].to(torch.int32)
            x = ((hi << 24) | (lo << 16)).view(torch.float32)
            y = x * sc + torch.tensor(fm.I8_ROUND, dtype=torch.float32)
            n = 8 * ng + 2 * cp + half
            b8[fm.i8_operand_index(I8_TN, n, k)] = (y.view(torch.int32) & 0xFF).to(torch.uint8)
    return a8.view(torch.int8), b8.view(torch.int8)


def dz_row_maxima(dz: torch.Tensor, tn: int) -> torch.Tensor:
    """A mirror of the 'i8pair' chain epilogue's row maxima (ChainEpi::
    rowmax): dz [n, H] (bf16 values) -> int32 [ceil(H / tn), n], each
    point's max |dz| over an N tile's tn columns as the bits of a
    non-negative float (NaN above every finite value)."""
    n, h = dz.shape
    bits = dz.float().abs().view(torch.int32)   # non-negative: bits order as values
    pad = -(-h // tn) * tn - h
    return F.pad(bits, (0, pad)).view(n, -1, tn).amax(2).t().contiguous()


def dz_group_maxima(rowmax: torch.Tensor, group: int) -> torch.Tensor:
    """A mirror of wide_dz_group_max_kernel: rowmax [tiles, n] (dz_row_maxima)
    -> f32 [ceil(n / group)], the max over each group's points below n and
    every tile, compared as bits."""
    n = rowmax.shape[1]
    pad = -(-n // group) * group - n
    return F.pad(rowmax.amax(0), (0, pad)).view(-1, group).amax(1).view(torch.float32)


def dw_tiles(config: NeRFConfig) -> int:
    """The most output tiles of one dW product (dW_in, dW_h, dW_out, and
    'i8pair''s int8 dW_h): the arrival counters' length."""
    h, ep = config.d_filter, e_pad(config)
    return max(i8_tiles(h), *(-(-m // TILE_M) * -(-n // tile_n(n, 64))
                              for m, n in ((ep, h), (h, h), (h, config.d_output))))


def operand_row_bytes(config: NeRFConfig) -> dict:
    """Each TMA operand of the wide GEMM as the launchers take it: (row
    stride, largest base offset) in bytes, the offset that of a layer's
    slice of the bf16 stash, of w_h, or of w_in's grid rows (K5's denc); the
    chain's gates are read from the stashes' first column on ('cs' the
    'int8' cos8, 'hs8' the 'i8pair' pairs; 'hs' also the 'lsb' and K4
    gates). TMA needs both multiples of 16."""
    h, L, ep, op = config.d_filter, config.n_layers, e_pad(config), o_pad(config.d_output)
    w_h_at = 2 * max(L - 2, 0) * h * h
    return {'enc': (2 * ep, 0), 'act': (2 * h, 0), 'hs': (2 * L * h, 2 * (L - 1) * h),
            'cs': (L * h, 0), 'hs8': (2 * L * h, 0),
            'w_in_t': (2 * ep, 0), 'w_h_t': (2 * h, w_h_at), 'w_out_t': (2 * h, 0),
            'dyb': (2 * op, 0), 'dz': (2 * h, 0), 'w_h_b': (2 * h, w_h_at),
            'w_out_b': (2 * op, 0), 'w_in_b': (2 * h, 2 * (config.d_encoded - config.d_grid) * h)}


def pack_wide(w_in: torch.Tensor, w_h: torch.Tensor, w_out: torch.Tensor) -> dict:
    """The forward's bf16 operands, each K-major: w_in^T [H, e_pad] (zero
    past E), w_h^T [L-1, H, H], w_out^T [d_out, H]."""
    e = w_in.shape[0]
    pad = -(-e // 16) * 16 - e
    bf = torch.bfloat16
    return dict(w_in_t=F.pad(w_in, (0, 0, 0, pad)).t().to(bf).contiguous(),
                w_h_t=w_h.transpose(-1, -2).to(bf).contiguous(),
                w_out_t=w_out.t().to(bf).contiguous())


def unpack_wide(ops: dict, d_encoded: int) -> tuple:
    """The inverse of pack_wide: (w_in [E, H], w_h [L-1, H, H], w_out
    [H, d_out]) bf16, the JAX layout."""
    return (ops['w_in_t'].t()[:d_encoded], ops['w_h_t'].transpose(-1, -2),
            ops['w_out_t'].t())


def pack_wide_bwd(w_in: torch.Tensor, w_h: torch.Tensor, w_out: torch.Tensor) -> dict:
    """The backward's bf16 operands, each K-major as stored: w_h [L-1, H, H]
    (the chain's B^T: dh = dz w_h^T), w_out [H, o_pad] (zero past d_out; the
    chain's first B^T), w_in [E, H] (K3's and K5's denc)."""
    bf = torch.bfloat16
    return dict(w_h_b=w_h.to(bf).contiguous(),
                w_out_b=F.pad(w_out, (0, o_pad(w_out.shape[1]) - w_out.shape[1])).to(bf).contiguous(),
                w_in_b=w_in.to(bf).contiguous())


def _cached(cache, params: dict, fn) -> dict:
    stamp = tuple((id(params[k]), fm._version(params[k])) for k in ('w_in', 'w_h', 'w_out'))
    hit = cache.get(params['w_in'])
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, fn(params['w_in'].float(), params['w_h'].float(),
                             params['w_out'].float()))
        cache[params['w_in']] = hit
    return hit[1]


def wide_operands(config: NeRFConfig, params: dict) -> dict:
    """The wide K0's operands as wide_mlp_fwd takes them, on the params'
    device: pack_wide's (cached), the encoding's columns, the f32 biases and
    the grid tables (live)."""
    col_dim, col_freq = fm._columns(config, params['w_in'].device)
    with torch.no_grad():
        return dict(_cached(_packs, params, pack_wide), col_dim=col_dim, col_freq=col_freq,
                    b_in=params['b_in'].float().contiguous(),
                    b_h=params['b_h'].float().contiguous(),
                    b_out=params['b_out'].float().contiguous(),
                    grids=[params[k] for k in fm.grid_keys(config)])


class _WideArgs(ctypes.Structure):
    """WideArgs of csrc/wide_mlp.cuh, passed by pointer."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        'pts', 'col_dim', 'col_freq', 'w_in_t', 'w_h_t', 'w_out_t', 'b_in', 'b_h', 'b_out',
        'grid', 'out', 'act', 'enc', 'hs', 'cs', 'dy', 'w_h_b', 'w_out_b', 'w_in_b', 'dyb',
        'dz', 'part', 'part_sum', 'g_w_in', 'g_b_in', 'g_w_h', 'g_b_h', 'g_w_out', 'g_b_out',
        'denc', 'dpts', 'dgrid', 'gmax', 'gacc', 'g_grid', 'group_max', 'tile_count',
        'db_part', 'dz_rowmax')]
        + [(k, ctypes.c_int) for k in ('n', 'd_in', 'n_cols', 'e_pad', 'h', 'n_hidden', 'd_out',
                                        'o_pad', 'fmt', 'group')])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(config: NeRFConfig, params: dict, points: torch.Tensor):
    """What the wide kernels take: CUDA float32 points [N, d_input], a width
    of a multiple of 16 (wide_field pads), d_output >= 1, no VM levels, grid
    levels of 2 or more cells."""
    if points.device.type != 'cuda':
        raise ValueError(f'no wide kernel for device {points.device}')
    if config.grid_rank:
        raise NotImplementedError(fm._NO_VM_KERNEL)
    if min(config.grid_sizes, default=2) < 2:
        raise ValueError(f'the wide kernels take grid levels of 2 or more cells a side, got '
                         f'{config.grid_sizes}')
    if config.d_filter % 16:
        raise ValueError(f'the wide kernels take d_filter a multiple of 16, got '
                         f'{config.d_filter}: fused_mlp_forward pads other widths (wide_field)')
    if config.d_output < 1:
        raise ValueError(f'the wide kernels take d_output from 1, got {config.d_output}')
    if points.dtype != torch.float32 or points.dim() != 2 \
            or points.shape[1] != config.d_input or not points.is_contiguous():
        raise ValueError(f'points must be contiguous float32 [N, {config.d_input}], got '
                         f'{points.dtype} {list(points.shape)}')
    for k in fm._KEYS:
        if params[k].device != points.device:
            raise ValueError(f'params[{k!r}] is on {params[k].device}, points on '
                             f'{points.device}')
    for k, g in zip(fm.grid_keys(config), config.grid_sizes):
        build.check_tensor(f'params[{k!r}]', params[k], (g, g, g, config.grid_features),
                           torch.float32, points.device)


def wide_field(config: NeRFConfig, params: dict) -> tuple:
    """fused_mlp._kernel_field at wide_width: the field zero-padded to a
    multiple of 16 units (a render's pad made once and reused)."""
    return fm._kernel_field(config, params, wide_width(config.d_filter))


def _fwd_args(points, ops: dict, grid, out, enc, fmt: int, hs=None, cs=None, act=None):
    n, d_in = points.shape
    h, hidden = ops['b_in'].numel(), ops['b_h'].shape[0]
    a = _WideArgs(pts=points.data_ptr(), col_dim=ops['col_dim'].data_ptr(),
                  col_freq=ops['col_freq'].data_ptr(), w_in_t=ops['w_in_t'].data_ptr(),
                  w_h_t=ops['w_h_t'].data_ptr(), w_out_t=ops['w_out_t'].data_ptr(),
                  b_in=ops['b_in'].data_ptr(), b_h=ops['b_h'].data_ptr(),
                  b_out=ops['b_out'].data_ptr(),
                  grid=ctypes.addressof(grid), out=_ptr(out), act=_ptr(act),
                  enc=enc.data_ptr(), hs=_ptr(hs), cs=_ptr(cs))
    a.n, a.d_in, a.n_cols, a.e_pad = n, d_in, ops['col_dim'].numel(), ops['w_in_t'].shape[1]
    a.h, a.n_hidden, a.d_out, a.fmt = h, hidden, ops['b_out'].numel(), fmt
    a.o_pad = o_pad(a.d_out)
    return a


def _launch_forward(points, ops: dict, grid_bound: float, fmt: int, hs=None, cs=None):
    """One forward of the wide kernels on wide_operands' dict: K0 (fmt 0), or
    the stashing forward of fmt into hs / cs -> out [N, d_out] f32."""
    n, d_in = points.shape
    dev = points.device
    h, hidden, d_out = ops['b_in'].numel(), ops['b_h'].shape[0], ops['b_out'].numel()
    grids = list(ops['grids'])
    features = grids[0].shape[-1] if grids else 0
    e = d_in + 2 * ops['col_dim'].numel() + len(grids) * features
    ep = -(-e // 16) * 16
    f32, bf16 = torch.float32, torch.bfloat16
    for name, t, shape, dtype in (
            ('points', points, (n, d_in), f32), ('w_in_t', ops['w_in_t'], (h, ep), bf16),
            ('w_h_t', ops['w_h_t'], (hidden, h, h), bf16),
            ('w_out_t', ops['w_out_t'], (d_out, h), bf16),
            ('col_dim', ops['col_dim'], ops['col_dim'].shape, torch.int32),
            ('col_freq', ops['col_freq'], ops['col_dim'].shape, f32),
            ('b_in', ops['b_in'], (h,), f32), ('b_h', ops['b_h'], (hidden, h), f32),
            ('b_out', ops['b_out'], (d_out,), f32),
            *((f'grids[{i}]', t, (t.shape[0],) * 3 + (features,), f32)
              for i, t in enumerate(grids))):
        build.check_tensor(name, t, shape, dtype, dev)
    if h % 16 or d_out < 1:
        raise ValueError(f'the wide kernels take d_filter a multiple of 16 and d_output >= 1, '
                         f'got {h} and {d_out}')
    out = torch.empty((n, d_out), dtype=f32, device=dev)
    if n == 0:
        return out
    grid = fm._grid_args_of(grids, features, grid_bound)
    enc = torch.empty((n, ep), dtype=bf16, device=dev)
    act = (torch.empty((2, n, h), dtype=bf16, device=dev) if fmt in (0, 2, 3) else None)
    args = _fwd_args(points, ops, grid, out, enc, fmt, hs, cs, act)
    build.launch('wide_mlp_fwd', (ctypes.c_void_p,), dev, ctypes.addressof(args))
    return out


@torch.library.custom_op('sunerf_tpu_torch::wide_mlp_fwd', mutates_args=())
def wide_mlp_fwd(points: torch.Tensor, w_in_t: torch.Tensor, w_h_t: torch.Tensor,
                 w_out_t: torch.Tensor, col_dim: torch.Tensor, col_freq: torch.Tensor,
                 b_in: torch.Tensor, b_h: torch.Tensor, b_out: torch.Tensor,
                 grids: list[torch.Tensor], grid_bound: float) -> torch.Tensor:
    """The wide K0 as a registered op, sunerf_tpu_torch::wide_mlp_fwd: raw
    [N, d_output] f32 of the field at points [N, d_input] from
    wide_operands (base offsets excluded). On CUDA tensors it launches
    csrc/wide_mlp_fwd.cu (or raises); on any other device it is the plain
    version, the weights read back by unpack_wide (bf16 values, so the bits
    of fused_mlp_reference)."""
    e = points.shape[1] + 2 * col_dim.numel() + sum(t.shape[-1] for t in grids)
    w_in, w_h, w_out = unpack_wide(dict(w_in_t=w_in_t, w_h_t=w_h_t, w_out_t=w_out_t), e)
    h = fm._encode_columns(points, col_dim.long(), col_freq, list(grids), grid_bound)
    for w, b in [(w_in, b_in)] + list(zip(w_h, b_h)):
        h = fm.reduced_sin(fm._mm(h, w.contiguous()) + b)
    return fm._mm(h, w_out.contiguous()) + b_out


@wide_mlp_fwd.register_fake
def _wide_mlp_fwd_fake(points, w_in_t, w_h_t, w_out_t, col_dim, col_freq, b_in, b_h, b_out,
                       grids, grid_bound):
    return points.new_empty((points.shape[0], b_out.shape[0]))


@wide_mlp_fwd.register_kernel('cuda')
def _wide_mlp_fwd_cuda(points, w_in_t, w_h_t, w_out_t, col_dim, col_freq, b_in, b_h, b_out,
                       grids, grid_bound):
    ops = dict(w_in_t=w_in_t, w_h_t=w_h_t, w_out_t=w_out_t, col_dim=col_dim,
               col_freq=col_freq, b_in=b_in, b_h=b_h, b_out=b_out, grids=list(grids))
    return _launch_forward(points, ops, grid_bound, 0)


def wide_mlp_packed(ops: dict, points: torch.Tensor, grid_bound: float) -> torch.Tensor:
    """wide_mlp_fwd on wide_operands' dict: the call an exported program
    makes, its operands baked in."""
    return wide_mlp_fwd(points, ops['w_in_t'], ops['w_h_t'], ops['w_out_t'], ops['col_dim'],
                        ops['col_freq'], ops['b_in'], ops['b_h'], ops['b_out'], ops['grids'],
                        grid_bound)


def wide_forward(config: NeRFConfig, params: dict, points: torch.Tensor) -> torch.Tensor:
    """The wide K0 wrapper: wide_mlp_fwd on this field's operands; CUDA
    tensors launch csrc/wide_mlp_fwd.cu (or raise), CPU tensors run the
    plain version. Counts a launch in eager calls."""
    global WIDE_LAUNCHES
    cuda = points.device.type == 'cuda'
    if cuda:
        _check(config, params, points)
    out = wide_mlp_packed(wide_operands(config, params), points, config.grid_bound)
    if cuda and points.shape[0] and not fm._tracing():
        WIDE_LAUNCHES += 1
    return out


def wide_stash_forward(config: NeRFConfig, params: dict, points: torch.Tensor,
                       fmt: str = 'int8'):
    """The wide stashing forward (K1 'int8', K6a 'lsb', K6b 'i8pair') ->
    (out, hs, cs) in the fused kernels' layouts (fused_mlp_stash_reference's).
    CUDA tensors launch csrc/wide_mlp_fwd.cu (or raise), CPU tensors run the
    plain version."""
    global WIDE_STASH_FWD_LAUNCHES
    if points.device.type == 'cpu':
        return fm.fused_mlp_stash_reference(config, params, points, fmt)
    _check(config, params, points)
    n, dev = points.shape[0], points.device
    hs_shape, hs_dtype, cs_shape, cs_dtype = fm._stash_shapes(config, n, fmt)
    hs = torch.empty(hs_shape, dtype=hs_dtype, device=dev)
    cs = None if cs_shape is None else torch.empty(cs_shape, dtype=cs_dtype, device=dev)
    out = _launch_forward(points, wide_operands(config, params), config.grid_bound,
                          _FWD_FMT[fmt], hs, cs)
    if n:
        WIDE_STASH_FWD_LAUNCHES += 1
    return out, hs, cs


def _launch_backward(config: NeRFConfig, params: dict, points: torch.Tensor, dy: torch.Tensor,
                     hs: torch.Tensor, cs, fmt: int, compute_dpts: bool,
                     group: int = fm.STASH_BWD_TILE) -> dict:
    """One backward of the wide kernels (fmt 1 'int8', 2 'lsb', 3 'i8pair'
    with its dz scale group, 4 K4's bf16 cos) from the stash -> the
    gradients in the JAX layout, 'dpts' with compute_dpts."""
    dev = points.device
    n, H, L, O = points.shape[0], config.d_filter, config.n_layers, config.d_output
    build.check_tensor('dy', dy, (n, O), torch.float32, dev)
    ops = wide_operands(config, params)
    bwd = _cached(_packs_bwd, params, pack_wide_bwd)
    ep, op = e_pad(config), o_pad(O)
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    g_w_in, g_b_in = torch.empty((ep, H), **f32), torch.empty(H, **f32)
    g_w_h, g_b_h = torch.empty((L - 1, H, H), **f32), torch.empty((L - 1, H), **f32)
    g_w_out, g_b_out = torch.empty((H, O), **f32), torch.empty(O, **f32)
    offsets = fm.grid_offsets(config)
    g_grid = torch.empty(offsets[-1], **f32)
    dpts = torch.empty((n, config.d_input), **f32) if compute_dpts else None
    grads = {'w_in': g_w_in[:config.d_encoded], 'b_in': g_b_in, 'w_h': g_w_h, 'b_h': g_b_h,
             'w_out': g_w_out, 'b_out': g_b_out}
    for i, (k, g) in enumerate(zip(fm.grid_keys(config), config.grid_sizes)):
        grads[k] = g_grid[offsets[i]:offsets[i + 1]].view(g, g, g, config.grid_features)
    if compute_dpts:
        grads['dpts'] = dpts
    if n == 0:
        for t in (g_w_in, g_b_in, g_w_h, g_b_h, g_w_out, g_b_out, g_grid):
            t.zero_()
        return grads
    grid = fm._grid_args(config, params)
    n_cols = ops['col_dim'].numel()
    enc = torch.empty((n, ep), **bf16)   # kept alive over the launch
    a = _fwd_args(points, ops, grid, None, enc, fmt, hs, cs)
    a.dy, a.w_h_b, a.w_out_b, a.w_in_b = (dy.data_ptr(), bwd['w_h_b'].data_ptr(),
                                          bwd['w_out_b'].data_ptr(), bwd['w_in_b'].data_ptr())
    i8 = fmt == _FWD_FMT['i8pair']
    scratch = dict(dyb=torch.empty((n, op), **bf16), dz=torch.empty((2, n, H), **bf16),
                   part=torch.empty(WIDE_MAX_SPLITS * max(ep * H, H * H, H * O), **f32),
                   part_sum=torch.empty(WIDE_SUM_PARTS * max(H, O), **f32),
                   denc=(torch.empty((n, config.d_input + 2 * n_cols), **f32)
                         if compute_dpts else None),
                   dgrid=torch.empty((n, config.d_grid), **f32),
                   gmax=torch.zeros(len(config.grid_sizes), dtype=torch.int32, device=dev),
                   gacc=torch.zeros(offsets[-1], dtype=torch.int64, device=dev),
                   group_max=(torch.empty(-(-n // group), dtype=torch.int32, device=dev)
                              if i8 else None),
                   tile_count=torch.zeros(dw_tiles(config), dtype=torch.int32, device=dev),
                   db_part=torch.empty((2 * -(-n // TILE_M), H), **f32),
                   dz_rowmax=(torch.empty((-(-H // TILE_M), n), dtype=torch.int32, device=dev)
                              if i8 else None))
    for k, t in scratch.items():
        setattr(a, k, _ptr(t))
    a.group = group
    for k, t in (('g_w_in', g_w_in), ('g_b_in', g_b_in), ('g_w_h', g_w_h), ('g_b_h', g_b_h),
                 ('g_w_out', g_w_out), ('g_b_out', g_b_out), ('dpts', dpts),
                 ('g_grid', g_grid)):
        setattr(a, k, _ptr(t))
    build.launch('wide_mlp_bwd', (ctypes.c_void_p,), dev, ctypes.addressof(a))
    if config.grid_sizes:
        # the grid cotangent onto the tables: the fused backward's scatter
        # and conversion (csrc/fused_mlp_stash_bwd.cu sunerf_grid_scatter)
        build.launch('fused_mlp_stash_bwd', build.signature(6, 2), dev, points.data_ptr(),
                     scratch['dgrid'].data_ptr(), scratch['gmax'].data_ptr(),
                     scratch['gacc'].data_ptr(), g_grid.data_ptr(), ctypes.addressof(grid),
                     n, config.d_input, entry='grid_scatter')
    return grads


def wide_stash_backward(config: NeRFConfig, params: dict, points: torch.Tensor,
                        dy: torch.Tensor, hs: torch.Tensor, cs, fmt: str = 'int8',
                        compute_dpts: bool = False, group: int = fm.STASH_BWD_TILE) -> dict:
    """The wide stashing backward (K2 'int8', K6a 'lsb', K6b 'i8pair' with
    its dz scale group of `group` points, with K3 for compute_dpts and K5 for
    grid levels) -> the gradients of fused_mlp_stash_bwd_reference. CUDA
    tensors launch csrc/wide_mlp_bwd.cu (or raise), CPU tensors run the
    plain version."""
    global WIDE_STASH_BWD_LAUNCHES
    if points.device.type == 'cpu':
        return fm.fused_mlp_stash_bwd_reference(config, params, points, dy, hs, cs, fmt,
                                                compute_dpts, group)
    _check(config, params, points)
    if fmt == 'i8pair':
        fm._check_group(group)
    hs_shape, hs_dtype, cs_shape, cs_dtype = fm._stash_shapes(config, points.shape[0], fmt)
    build.check_tensor('hs', hs, hs_shape, hs_dtype, points.device)
    if cs_shape is not None:
        build.check_tensor('cs', cs, cs_shape, cs_dtype, points.device)
    grads = _launch_backward(config, params, points, dy, hs, cs, _FWD_FMT[fmt], compute_dpts,
                             group)
    if points.shape[0]:
        WIDE_STASH_BWD_LAUNCHES += 1
    return grads


def wide_recompute_backward(config: NeRFConfig, params: dict, points: torch.Tensor,
                            dy: torch.Tensor) -> dict:
    """The wide K4 -> the gradients and 'dpts' of
    fused_mlp_recompute_bwd_reference: for each chunk of
    fused_mlp.RECOMPUTE_CHUNK points the wide forward with the bf16 sin and
    cos10 stash, then the wide backward with that cos as the gate; the
    chunks' gradients summed in order. CUDA tensors launch (or raise), CPU
    tensors run the plain version."""
    global WIDE_RECOMPUTE_BWD_LAUNCHES
    if points.device.type == 'cpu':
        return fm.fused_mlp_recompute_bwd_reference(config, params, points, dy)
    _check(config, params, points)
    n, lh = points.shape[0], config.n_layers * config.d_filter
    ops = wide_operands(config, params)
    total = None
    for c0 in range(0, n, fm.RECOMPUTE_CHUNK):
        x, g = points[c0:c0 + fm.RECOMPUTE_CHUNK], dy[c0:c0 + fm.RECOMPUTE_CHUNK]
        hs, cs = (torch.empty((x.shape[0], lh), dtype=torch.bfloat16, device=x.device)
                  for _ in range(2))
        _launch_forward(x, ops, config.grid_bound, _FWD_FMT['recompute'], hs, cs)
        grads = _launch_backward(config, params, x, g, hs, cs, _FWD_FMT['recompute'], True)
        if total is None:
            total = grads
        else:
            total = {k: torch.cat([total[k], v]) if k == 'dpts' else total[k] + v
                     for k, v in grads.items()}
    if total is None:
        total = _launch_backward(config, params, points, dy, None, None, 4, True)
    else:
        WIDE_RECOMPUTE_BWD_LAUNCHES += 1
    return total

