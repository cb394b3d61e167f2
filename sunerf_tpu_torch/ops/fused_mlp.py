"""Fused positional encoding + Sine MLP: the ports of the TPU kernels of
sunerf_tpu/ops/pallas/fused_mlp.py.

  K0 _fwd_kernel        -> csrc/fused_mlp_fwd_wgmma.cu  forward, no gradient
                           (wgmma from a bulk-copy weight ring,
                           csrc/fused_mlp_fwd_wgmma.cuh)
  K1 _fwd_stash_kernel  -> csrc/fused_mlp_stash_fwd.cu  training forward,
                           sin stash bf16 + cos stash int8 ('int8'): K0's
                           wgmma kernel with the stashes in its epilogue
  K2 _bwd_stash_kernel  -> csrc/fused_mlp_stash_bwd.cu  training backward:
                           the wgmma chain kernel and the wgmma dW kernel
                           (csrc/fused_mlp_backward.cuh)
  K3 its compute_dpts=True branch -> the same file: the point cotangent
  K4 _bwd_kernel        -> csrc/fused_mlp_recompute_bwd.cu  the recompute
                           backward of stash=False (no activation memory)
  K5 the dense feature-grid branch of K0-K2 (_encode_grid, d_table), any
     number of levels (grid_descriptors): trilinear features of each
     level's [G, G, G, F] table after the sin/cos columns
     (grid_level_features in csrc/fused_mlp_common.cuh, staged by the
     forward's grid warp), and in K2 the grid cotangent on wgmma
     (pack_wgmma_grid) and the tables' gradients, scattered a quad of lanes
     a (point, level) (grid_scatter_item) and summed in fixed point so a
     run gives the same bits as the last
  K6a _fwd_stash_lsb_kernel and the lsb branch of K2 ('lsb': one bf16
      stream, sign(cos) in the sin's last bit; the backward brings it
      through the chain kernel's weight ring and decodes it there,
      lsb_cos_decode)
  K6b _fwd_stash_i8pair_kernel, _mm_i8 and the i8pair branch of K2
      ('i8pair': one int8 stream of sin/cos pairs, dW_h on the int8
      tensor cores: dw_i8_wgmma_kernel, i8_build_operands)

`fused_mlp_forward` is the entry, with fused_nerf_raw's knobs. The kernels
are built for the widths of KERNEL_WIDTHS; on the card a field of another
d_filter up to 512 runs at the next of them, zero-padded (`kernel_width`,
`pad_field`: a padded unit's pre-activation is 0, its sin 0 and its outgoing
weights 0, so the field and the real entries' gradients are unchanged),
and the pad is an F.pad outside the autograd Functions, so autograd slices
the gradients back to the caller's shapes. A field above 512 units, or
with d_output outside the fused heads (1..8 forward, 1..4 where a backward
runs), takes the wide route instead (`kernel_route`; ops/wide_mlp.py, one
launch a layer, padded to a multiple of 16 units), the same wrappers and
autograd Functions dispatching to it. With no
gradient needed it runs K0. When a parameter (or, with compute_dpts, the
points) needs one it runs, for stash=True (or None), `FusedMLPStash`, the
autograd Function whose forward is the stashing forward of `stash_format`
(K1, K6a or K6b) and whose backward is K2 (with K3 for the points), as the
JAX package's custom_vjp `_fused_mlp_stash` is; for stash=False
`FusedMLPRecompute`, whose forward is K0 and whose backward is K4, as
`_fused_mlp`. VM grid levels (grid_rank > 0) have no kernel, as in the JAX
package; dense grid levels take the 'int8' stash and no point cotangent.

Each kernel's wrapper launches it for CUDA tensors, checks the CUDA error
code the launch returns and raises on any failure; for CPU tensors it runs
the kernel's plain PyTorch version (`fused_mlp_reference`,
`fused_mlp_stash_reference`, `fused_mlp_stash_bwd_reference`,
`fused_mlp_recompute_bwd_reference`), which repeats its numerics: bf16
matmul operands, f32 accumulation, f32 bias and the kernels' range-reduced
sine. Raw outputs exclude the DT base offsets (nerf_apply_fused adds them).

The kernels read bf16 copies of the weights laid out as wgmma's ring
chunks: the forwards' `pack_wgmma`, the backwards' `pack_wgmma_bwd` (W_h as
stored) and, only when a backward computes the point cotangent,
`pack_wgmma_dpts` (W_in's x, sin and cos rows ordered by input dimension,
`dpts_layout`, so the point cotangent takes any d_input), each prepared once per
parameter set and cached on the identity and version of its tensors: a
training step packs once per field, and the optimizer's in-place update
invalidates the pack. The backward's dz scratch is laid out tile by tile
in the chain kernel's own order (`dz_index`), and its dW products are
split over the point ranges of `dw_splits` ('i8pair''s int8 dW_h over
those of `dw_i8_splits`, whole scale groups, whose maxima come from each
point's, i8pair_group_maxima). The grid tables
are not cached: the kernels read the float32 parameters themselves, so an
in-place update is seen by the next launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from sunerf_tpu_torch.core.encoding import encoded_dim, encoding_columns
from sunerf_tpu_torch.models.fields import NeRFConfig
from sunerf_tpu_torch.ops import build
from sunerf_tpu_torch.ops.grid_encoding import grid_encode, grid_encode_table_grad

# kernel launches so far, one per wrapper call that launched: a run sets them
# to 0 and reads them to show that its fields went through the kernels
LAUNCHES = 0               # K0, fused_mlp_fwd_wgmma
STASH_FWD_LAUNCHES = 0     # stashing forwards, fused_mlp_stash_fwd (K1, K6a, K6b)
STASH_BWD_LAUNCHES = 0     # stashing backwards, fused_mlp_stash_bwd (K2, K6a, K6b)
GRID_LAUNCHES = 0          # K5: launches of K0, K1 or K2 with grid levels
DPTS_LAUNCHES = 0          # K3: launches of the stashing backward with dpts
RECOMPUTE_BWD_LAUNCHES = 0  # K4, fused_mlp_recompute_bwd
LSB_LAUNCHES = 0           # K6a: 'lsb' stashing forward and backward launches
I8PAIR_LAUNCHES = 0        # K6b: 'i8pair' stashing forward and backward launches

KERNEL_WIDTHS = (64, 128, 256, 384, 512)   # d_filter values the kernels take
_WGMMA_KC = 32          # K0's weight rows per ring chunk
MAX_K0_OUTPUTS = 8      # d_output values K0 takes: 1..8, its head's wgmma width
MAX_BWD_OUTPUTS = 4                         # d_output values K2 takes: 1..4
GRID_STAGE_COLS = 32    # K5's grid-cotangent columns a ring stage of the chain kernel
_KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
_NO_VM_KERNEL = ('VM grid levels (grid_rank > 0) have no fused kernel; they run '
                 'the float32 field (use_fused=False), as in the JAX package')
_NO_GRID_DPTS = ('grid-encoding configs skip point cotangents (the renderer '
                 'detaches sample points); pass compute_dpts=False or use nerf_apply')
_NO_GRID_RECOMPUTE = ('grid-encoding configs differentiate through the stashing '
                      'backward only (stash=True); the recompute backward has no '
                      'd_table path')
_prepared: WeakIdKeyDictionary = WeakIdKeyDictionary()
_prepared_dpts: WeakIdKeyDictionary = WeakIdKeyDictionary()
_prepared_wgmma: WeakIdKeyDictionary = WeakIdKeyDictionary()
_prepared_bwd: WeakIdKeyDictionary = WeakIdKeyDictionary()
_padded: WeakIdKeyDictionary = WeakIdKeyDictionary()
_TWO_PI = 6.283185307179586
_INV_TWO_PI = 0.15915494309189535
_HALF_PI = 1.5707963267948966
# degree-8 even cos polynomial of the TPU kernel (_COS8_C, max abs err 4.1e-5)
_COS8_C = (9.999598405e-01, -4.997933042e-01, 4.149612510e-02,
           -1.339285342e-03, 1.879295230e-05)
# the TPU kernels' polynomials: odd degree-11 sin on [-pi, pi] (fast_sin)
# and even degree-10 cos (_COS_C of fast_sincos, max abs err 7.8e-7)
_SIN_C = (9.999995999e-01, -1.666655263e-01, 8.332402961e-03,
          -1.980863262e-04, 2.699713829e-06, -2.036221213e-08)
_COS_C = (9.999992216e-01, -4.999942681e-01, 4.165982217e-02,
          -1.385891583e-03, 2.420439995e-05, -2.197887694e-07)
_HALF_PI_SQ = 2.4674011002723395    # (pi/2)^2
_COS_SCALE = 127.0
# bf16(1 / 127), the dequantization factor of the int8 stashes
_INV_COS_SCALE_BF16 = 0.00787353515625
# f32((1/127)^2), the i8pair dW scale factor (exact in f32, so every
# rounding path gives the same value)
_INV_COS_SQ = float(np.float32((1.0 / 127.0) * (1.0 / 127.0)))
_TILE = 64              # points a chain tile and a dW chunk (csrc/fused_mlp_backward.cuh)
_DW_ROWS = 128          # dW output rows a work item
_DPTS_COLS = 128        # K3's pack columns a ring chunk (fewer at H = 64)
STASH_FORMATS = ('int8', 'lsb', 'i8pair')
_FMT_CODE = {'int8': 0, 'lsb': 1, 'i8pair': 2}
STASH_BWD_TILE = 768    # the i8pair dz scale group: fused_nerf_raw's stash_bwd_tile
RECOMPUTE_CHUNK = 32768  # K4's points per recompute chunk (a multiple of 64)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (to nearest even) and back to f32."""
    return x.to(torch.bfloat16).float()


def _reduce(x: torch.Tensor) -> torch.Tensor:
    """x - 2*pi*round(x / 2*pi) with 2*pi rounded to f32, the kernels' range
    reduction."""
    return x - torch.round(x * _INV_TWO_PI).mul_(_TWO_PI)


def reduced_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) after the kernels' range reduction. The reduction is what sets
    the kernels' sine apart from torch.sin (by up to ~4e-6 at the |z| ~ 70
    pre-activations of the trained field, enough to flip bf16 roundings
    downstream); on the reduced argument the kernels' minimax polynomial is
    within 1e-7 of torch.sin."""
    return torch.sin(_reduce(x))


def cos8_quantized(y: torch.Tensor) -> torch.Tensor:
    """int8 round-half-even(127 * cos8(y)) of a range-reduced argument y:
    the TPU kernel's int8 cos stash (fast_sincos_q)."""
    y2 = y * y
    d0, d1, d2, d3, d4 = _COS8_C
    c = d0 + y2 * (d1 + y2 * (d2 + y2 * (d3 + y2 * d4)))
    return torch.round(c * _COS_SCALE).to(torch.int8)


def _sin_poly(y: torch.Tensor) -> torch.Tensor:
    y2 = y * y
    c0, c1, c2, c3, c4, c5 = _SIN_C
    return y * (c0 + y2 * (c1 + y2 * (c2 + y2 * (c3 + y2 * (c4 + y2 * c5)))))


def _cos10(y: torch.Tensor) -> torch.Tensor:
    y2 = y * y
    d0, d1, d2, d3, d4, d5 = _COS_C
    return d0 + y2 * (d1 + y2 * (d2 + y2 * (d3 + y2 * (d4 + y2 * d5))))


def fast_sincos(x: torch.Tensor):
    """(sin x, cos x) of one range reduction, the TPU kernels' fast_sincos
    (the recompute backward's sin and its degree-10 cos), every operation
    rounded on its own: the JAX function's bits, op by op."""
    y = _reduce(x)
    return _sin_poly(y), _cos10(y)


def fast_sin_csign(x: torch.Tensor):
    """(sin x, cos x < 0): the sign from y^2 > (pi/2)^2 of the reduced y,
    the 'lsb' stash's bit (fast_sin_csign)."""
    y = _reduce(x)
    return _sin_poly(y), y * y > _HALF_PI_SQ


def pack_sin_csign(h: torch.Tensor, neg_cos: torch.Tensor) -> torch.Tensor:
    """bf16 h with its last mantissa bit replaced by neg_cos (1 = cos < 0):
    the 'lsb' stash (_pack_sin_csign)."""
    bits = h.to(torch.bfloat16).view(torch.int16)
    bits = (bits & -2) | neg_cos.to(torch.int16)
    return bits.view(torch.bfloat16)


def unpack_sin_cos(raw: torch.Tensor):
    """Inverse of pack_sin_csign: (raw, bf16 cos), cos = sign sqrt(max(1 -
    s^2, 0)) in f32 from the packed value s itself (_unpack_sin_cos)."""
    neg = (raw.view(torch.int16) & 1) != 0
    s = raw.float()
    c = torch.sqrt(torch.clamp_min(1.0 - s * s, 0.0))
    return raw, torch.where(neg, -c, c).to(torch.bfloat16)


LSB_TABLE_LO = 0x3D80    # |s| >= 2^-4: the first magnitude whose 'lsb' gate is not 1
LSB_TABLE = 0x3F80 - LSB_TABLE_LO   # 512 entries, up to |s| < 1


def lsb_cos_decode(raw: torch.Tensor) -> torch.Tensor:
    """The kernels' 'lsb' gate decode on int16 bits -> int16 bits of the
    bf16 cos. CUDA tensors run the chain kernel's own decode
    (csrc/fused_mlp_backward.cuh lsb_decode_kernel: lsb_cos_table with the
    block's table); CPU tensors its plain version, the same rule: a =
    bits & 0x7FFF below LSB_TABLE_LO gives 1.0, from 0x3F80 to 0x7F80
    (|s| >= 1) 0, above it (NaN) NaN, and the LSB_TABLE values between
    unpack_sin_cos's magnitudes; the sign from the last bit."""
    if raw.device.type == 'cuda':
        build.check_tensor('raw', raw, (raw.numel(),), torch.int16, raw.device)
        out = torch.empty_like(raw)
        if raw.numel():
            build.launch('fused_mlp_stash_bwd', build.signature(2, 1), raw.device,
                         raw.data_ptr(), out.data_ptr(), raw.numel(), entry='lsb_decode')
        return out
    h = raw.to(torch.int32) & 0xFFFF
    a = h & 0x7FFF
    lo = (LSB_TABLE_LO + torch.arange(LSB_TABLE)).to(torch.int16)
    table = unpack_sin_cos(lo.view(torch.bfloat16))[1].view(torch.int16).to(torch.int32) & 0x7FFF
    mag = torch.where(a < LSB_TABLE_LO, 0x3F80, torch.where(a > 0x7F80, 0x7FC0, 0))
    inside = (a >= LSB_TABLE_LO) & (a < LSB_TABLE_LO + LSB_TABLE)
    mag = torch.where(inside, table[(a - LSB_TABLE_LO).clamp(0, LSB_TABLE - 1)], mag)
    return (mag | ((h & 1) << 15)).to(torch.int16)


def i8pair_group_maxima(dz: torch.Tensor, group: int) -> torch.Tensor:
    """The i8pair dz scale groups' maxima as the kernels find them: each
    point's max |dz_j| (the chain kernel's row maxima), then each group's
    max over its points (dz_group_max_kernel; past n nothing) -> [groups]
    f32, NaN propagating as in jnp.max. dz [n, H] holds bf16 values."""
    n = dz.shape[0]
    rows = dz.abs().amax(1)
    pad = -(-n // group) * group - n
    return F.pad(rows, (0, pad)).view(-1, group).amax(1)


I8_ROUND = 12582912.0   # 1.5 2^23: x + it, rounded, holds round_half_even(x) in its low bits


def i8_operand_index(rows: int, row, k):
    """Byte of element (row, k) in dw_i8_wgmma_kernel's int8 operands: K-major
    no-swizzle core matrices of 8 rows x 16 k, ((k // 16) (rows // 8) +
    row // 8) 128 + (row % 8) 16 + k % 16 for `rows` rows (128 for A, TN for
    B). Works on ints and integer arrays alike."""
    return ((k // 16) * (rows // 8) + row // 8) * 128 + (row % 8) * 16 + k % 16


def i8_point(k):
    """The chunk point (0..63) behind K index k of dw_i8_wgmma_kernel's
    products: k = 16 kg + 8 h + j <-> point 8 j + 2 kg + h, so that a
    thread's points 8 j + q fill 8 contiguous bytes of a core-matrix row."""
    return 8 * (k % 8) + 2 * (k // 16) + (k // 8) % 2


def i8_build_operands(box: torch.Tensor, dz_tile: torch.Tensor, s0: int, s1: int,
                      scale: float, tn: int):
    """A mirror of build_a8 and build_b8 (csrc/fused_mlp_backward.cuh) for
    one segment of a 64-point chunk: box [64 points, 128] int8 (the stash
    box, stored 128-byte swizzled as TMA writes it), dz_tile [64, tn] bf16
    (stored in the chain's core-matrix order) -> the int8 operand buffers
    A [128 * 64] and B [tn * 64] as the 256 threads write them: thread t
    (warp w, lane l, q = l // 4) loads the points 8 j + q (j = 0..7) from
    the stored layouts at the columns m = 16 w + 4 (l % 4) + e (A, 4 bytes a
    load) and n = 8 ng + 2 (l % 4) + e (B, 2 bf16 a load, ng = (tn // 64) w
    + u) and stores their 8 bytes at i8_operand_index's row (m or n), k =
    16 (q // 2) + 8 (q % 2); B's bytes are the low bytes of dz * scale +
    I8_ROUND in f32 for points [s0, s1), 0 for the others."""
    t = torch.arange(256)
    w, lane = t // 32, t % 32
    q = (lane // 4).view(256, 1, 1)
    j = torch.arange(8).view(1, 1, 8)
    pt = 8 * j + q                                            # [256, 1, 8]
    k = 16 * (q // 2) + 8 * (q % 2) + j
    e = torch.arange(4).view(1, 4, 1)
    # A: stored box bytes at the 128-byte swizzle
    pr = torch.arange(64).view(64, 1)
    byte = torch.arange(128).view(1, 128)
    stored_a = torch.zeros(64 * 128, dtype=torch.uint8)
    stored_a[(pr * 128 + (((byte // 16) ^ (pr % 8)) % 8) * 16 + byte % 16).reshape(-1)] = \
        box.view(torch.uint8).reshape(-1)
    m = (16 * w + 4 * (lane % 4)).view(256, 1, 1) + e        # [256, 4, 1]
    at = pt * 128 + (((m // 16) ^ (pt % 8)) % 8) * 16 + m % 16
    a8 = torch.zeros(128 * 64, dtype=torch.uint8)
    a8[i8_operand_index(128, m, k)] = stored_a[at]
    # B: stored dz bits in the chain's core-matrix order
    col = torch.arange(tn).view(1, tn)
    stored_b = torch.zeros(64 * tn, dtype=torch.int16)
    stored_b[(((col // 8) * 8 + pr // 8) * 64 + (pr % 8) * 8 + col % 8).reshape(-1)] = \
        dz_tile.view(torch.int16).reshape(-1)
    b8 = torch.zeros(tn * 64, dtype=torch.uint8)
    sc = torch.where((pt >= s0) & (pt < s1), torch.tensor(scale, dtype=torch.float32),
                     torch.tensor(0.0))
    for u in range(tn // 64):
        n = (8 * ((tn // 64) * w + u) + 2 * (lane % 4)).view(256, 1, 1) + e[:, :2]
        bits = stored_b[((n // 8) * 8 + pt // 8) * 64 + (pt % 8) * 8 + n % 8]
        x = (bits.to(torch.int32) << 16).view(torch.float32)
        y = x * sc + torch.tensor(I8_ROUND, dtype=torch.float32)
        b8[i8_operand_index(tn, n, k)] = (y.view(torch.int32) & 0xFF).to(torch.uint8)
    return a8.view(torch.int8), b8.view(torch.int8)


def grid_keys(config: NeRFConfig) -> tuple:
    """The dense grid tables' parameter keys, in level order."""
    return tuple(f'grid_{i}' for i in range(len(config.grid_sizes)))


def param_keys(config: NeRFConfig) -> tuple:
    """The parameters the kernels read: the MLP's, then the grid tables."""
    return _KEYS + grid_keys(config)


def _grid_offset(config: NeRFConfig) -> int:
    """The first grid column of the encoding (after x, sin and cos)."""
    return encoded_dim(config.d_input, config.n_freqs, config.n_freqs_time)


def _encode(config: NeRFConfig, params: dict, points: torch.Tensor) -> torch.Tensor:
    """[x, sin u, cos u, grid features] as the kernels compute it: cos
    features are sin(u + pi/2) with u + pi/2 rounded to f32, as in the TPU
    kernel; each grid level's features are grid_encode's, f32."""
    dims, freqs = encoding_columns(config.d_input, config.n_freqs,
                                   config.scale_factor, config.n_freqs_time)
    return _encode_columns(points, dims, torch.tensor(freqs, dtype=points.dtype,
                                                      device=points.device),
                           [params[k] for k in grid_keys(config)], config.grid_bound)


def _encode_columns(points: torch.Tensor, dims, freqs: torch.Tensor, tables: list,
                    bound: float) -> torch.Tensor:
    """_encode from the encoding's columns (each sin/cos column's input
    dimension and frequency) and the grid tables."""
    u = points[:, dims] * freqs
    grid = [grid_encode(t, points, bound) for t in tables]
    return torch.cat([points, reduced_sin(u), reduced_sin(u + _HALF_PI)] + grid,
                     dim=-1)


def _layers(params: dict):
    return [(params['w_in'], params['b_in'])] + list(zip(params['w_h'],
                                                         params['b_h']))


def fused_mlp_reference(config: NeRFConfig, params: dict,
                        points: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K0: the same function with the same
    roundings (bf16 matmul operands, f32 accumulation, f32 bias, and sines
    of arguments range-reduced as the kernels reduce them)."""
    h = _encode(config, params, points)
    for w, b in _layers(params):
        h = reduced_sin(_mm(h, w) + b)
    return _mm(h, params['w_out']) + params['b_out']


def _stash_layers(config: NeRFConfig, params: dict, points: torch.Tensor,
                  inputs: torch.Tensor = None):
    """Each Sine layer's (bf16 sin, range-reduced pre-activation y). Layer
    i+1's input is layer i's bf16 sin, or, given `inputs` (a bf16 sin
    stash), that stash's block i."""
    H = config.d_filter
    h = _encode(config, params, points)
    hs, ys = [], []
    for i, (w, b) in enumerate(_layers(params)):
        y = _reduce(_mm(h, w) + b)
        hs.append(torch.sin(y).to(torch.bfloat16))
        ys.append(y)
        h = hs[-1] if inputs is None else inputs[:, i * H:(i + 1) * H]
    return hs, ys


def _stash_of(fmt: str, hs: list, ys: list):
    """(hs, cs) of a stash format from each layer's bf16 sin and reduced y:
    'int8' bf16 sin and int8 cos8 x127; 'lsb' the sin packed with the cos
    sign (cs None); 'i8pair' [round(127 sin) | int8 cos8] per layer in one
    int8 row (cs None)."""
    if fmt == 'int8':
        return torch.cat(hs, 1), torch.cat([cos8_quantized(y) for y in ys], 1)
    if fmt == 'lsb':
        return torch.cat([pack_sin_csign(h, y * y > _HALF_PI_SQ)
                          for h, y in zip(hs, ys)], 1), None
    if fmt == 'i8pair':
        return torch.cat([t for y in ys for t in (
            torch.round(torch.sin(y) * _COS_SCALE).to(torch.int8), cos8_quantized(y))],
            1), None
    raise ValueError(f'stash_format must be one of {STASH_FORMATS}, got {fmt!r}')


def fused_mlp_stash_reference(config: NeRFConfig, params: dict,
                              points: torch.Tensor, fmt: str = 'int8'):
    """Plain PyTorch version of the stashing forwards -> (out [N, d_out]
    f32, hs, cs). out is K0's (bit for bit fused_mlp_reference's). 'int8'
    (K1): hs [N, L*H] bf16, layer i's block the bf16 sine that feeds layer
    i+1, and cs [N, L*H] the int8 cos8 of the same reduced argument; 'lsb'
    (K6a): hs the packed bf16 sin, cs None; 'i8pair' (K6b): hs int8
    [N, 2*L*H], cs None."""
    hs, ys = _stash_layers(config, params, points)
    out = _mm(hs[-1], params['w_out']) + params['b_out']
    return (out, *_stash_of(fmt, hs, ys))


def fused_mlp_stash_layerwise(config: NeRFConfig, params: dict,
                              points: torch.Tensor, hs: torch.Tensor,
                              fmt: str = 'int8'):
    """(hs, cs) of the plain version in format `fmt` with each layer's
    input taken from the given bf16 sin stash (K1's hs; layer 0's input
    from the encoding): the stash that a kernel should write given its own
    upstream activations, which are K1's in every format. Holding a
    kernel's stash to it isolates each layer's roundings from the bf16
    flips upstream, which compound over the layers."""
    return _stash_of(fmt, *_stash_layers(config, params, points, inputs=hs))


def _dw_i8(s8: torch.Tensor, dz: torch.Tensor, group: int) -> torch.Tensor:
    """The i8pair dW_h: per group of `group` points, m = max|dz| (f32),
    scale = 127 / m (0 when m = 0; a rounded division, as JAX's and the
    kernel's, not 127 times a rounded 1 / m), dz8 = round_half_even(dz
    scale); the group's exact integer sum s8^T dz8 (float64 products of
    integers below 2^53) to f32, times f32(m * (1/127)^2), summed over the
    groups in order in f32."""
    n, H = dz.shape
    acc = torch.zeros((s8.shape[1], H), dtype=torch.float32, device=dz.device)
    for g0 in range(0, n, group):
        d = dz[g0:g0 + group]
        m = d.abs().max()
        scale = torch.where(m > 0, torch.full_like(m, _COS_SCALE) / m, torch.zeros_like(m))
        dz8 = torch.round(d * scale)
        prod = (s8[g0:g0 + group].double().t() @ dz8.double()).float()
        acc = acc + prod * (m * _INV_COS_SQ)
    return acc


def _point_cotangent(config: NeRFConfig, params: dict, points: torch.Tensor,
                     dz0: torch.Tensor) -> torch.Tensor:
    """K3: dpts = denc_x + (cos u dsin - sin u dcos) K^T with denc =
    dz_0 bf16(W_in[:n_enc])^T over the x, sin and cos columns, u = x K in
    f32 and its sine and cosine by the kernels' range reduction."""
    D = config.d_input
    dims, freqs = encoding_columns(D, config.n_freqs, config.scale_factor,
                                   config.n_freqs_time)
    nc = len(dims)
    denc = dz0 @ _bf(params['w_in'][:D + 2 * nc]).t()
    f = torch.tensor(freqs, dtype=points.dtype, device=points.device)
    u = points[:, dims] * f
    du = reduced_sin(u + _HALF_PI) * denc[:, D:D + nc] - reduced_sin(u) * denc[:, D + nc:]
    k = torch.zeros((D, nc), dtype=points.dtype, device=points.device)
    k[torch.tensor(dims, device=points.device), torch.arange(nc, device=points.device)] = f
    return denc[:, :D] + du @ k.t()


def _chain_grads(config: NeRFConfig, params: dict, points: torch.Tensor,
                 dy: torch.Tensor, sin_, cos_, dw_h, compute_dpts: bool,
                 dzs: list = None) -> dict:
    """The backward of every format given the layers' stashed sin (the dW
    operand), their gate cos and the hidden layers' dW product; with
    compute_dpts the point cotangent under 'dpts'. Given a list `dzs`, each
    layer's dz_j is put at its index j."""
    H, L = config.d_filter, config.n_layers
    dyb = _bf(dy)
    grads = {'w_out': sin_(L - 1).t() @ dyb, 'b_out': dy.sum(0)}
    dh = dyb @ _bf(params['w_out']).t()
    dws, dbs = [None] * (L - 1), [None] * (L - 1)
    if dzs is not None:
        dzs[:] = [None] * L
    for i in range(L - 2, -1, -1):
        dz = _bf(_bf(dh) * cos_(i + 1))
        if dzs is not None:
            dzs[i + 1] = dz
        dws[i] = dw_h(i, dz)
        dbs[i] = dz.sum(0)
        dh = dz @ _bf(params['w_h'][i]).t()
    dz = _bf(_bf(dh) * cos_(0))
    if dzs is not None:
        dzs[0] = dz
    grads['w_in'] = _bf(_encode(config, params, points)).t() @ dz
    grads['b_in'] = dz.sum(0)
    empty = torch.zeros((0, H), dtype=torch.float32, device=points.device)
    grads['w_h'] = torch.stack(dws) if dws else empty.reshape(0, H, H)
    grads['b_h'] = torch.stack(dbs) if dbs else empty
    if config.grid_sizes:
        F_ = config.grid_features
        off = _grid_offset(config)
        denc = dz @ _bf(params['w_in'][off:off + config.d_grid]).t()
        for i, (k, g) in enumerate(zip(grid_keys(config), config.grid_sizes)):
            grads[k] = grid_encode_table_grad(points, denc[:, i * F_:(i + 1) * F_],
                                              g, config.grid_bound)
    if compute_dpts:
        grads['dpts'] = _point_cotangent(config, params, points, dz)
    return grads


def fused_mlp_stash_bwd_reference(config: NeRFConfig, params: dict,
                                  points: torch.Tensor, dy: torch.Tensor,
                                  hs: torch.Tensor, cs: torch.Tensor,
                                  fmt: str = 'int8', compute_dpts: bool = False,
                                  group: int = STASH_BWD_TILE, dzs: list = None) -> dict:
    """Plain PyTorch version of the stashing backward -> parameter gradients
    in the JAX layout (w_in [E, H], b_in [H], w_h [L-1, H, H], b_h [L-1, H],
    w_out [H, O], b_out [O], grid_i [G, G, G, F]), f32, and with
    compute_dpts the point cotangent (K3) under 'dpts' [N, d_in]. The TPU
    kernel's roundings: dy enters both its products as bf16; dz is the bf16
    product of bf16(dh) and the layer's gate; products take bf16 operands
    and accumulate in f32; bias gradients sum dz (and dy) in f32; the
    encoding is recomputed from the points. The gate and the stashed sin by
    format: 'int8' (K2) bf16(bf16(cs) * bf16(1/127)) and hs; 'lsb' (K6a)
    bf16(sign sqrt(max(1 - s^2, 0))) of the packed hs in f32, and the packed
    hs itself; 'i8pair' (K6b) bf16(bf16(q) * bf16(1/127)) of the int8 cos
    and sin, and dW_h from the int8 sin and dz quantized per group of
    `group` points (_dw_i8). A grid level's cotangent is dz_0
    bf16(w_in[its rows])^T, spread over its table by grid_encode_table_grad
    (float32 index_add). Given a list `dzs`, it receives each layer's dz_j
    [N, H] (bf16 values in f32), the chain's intermediates that the kernel
    stores to its dz scratch."""
    H = config.d_filter
    if fmt == 'i8pair':
        def sin8(i):
            return hs[:, 2 * i * H:2 * i * H + H]

        def sin_(i):
            return _bf(sin8(i).float() * _INV_COS_SCALE_BF16)

        def cos_(i):
            return _bf(hs[:, 2 * i * H + H:2 * (i + 1) * H].float() * _INV_COS_SCALE_BF16)

        def dw_h(i, dz):
            return _dw_i8(sin8(i), dz, group)
    else:
        def sin_(i):
            return hs[:, i * H:(i + 1) * H].float()

        if fmt == 'lsb':
            def cos_(i):
                return unpack_sin_cos(hs[:, i * H:(i + 1) * H])[1].float()
        elif fmt == 'int8':
            def cos_(i):
                return _bf(cs[:, i * H:(i + 1) * H].float() * _INV_COS_SCALE_BF16)
        else:
            raise ValueError(f'stash_format must be one of {STASH_FORMATS}, got {fmt!r}')

        def dw_h(i, dz):
            return sin_(i).t() @ dz
    return _chain_grads(config, params, points, dy, sin_, cos_, dw_h, compute_dpts, dzs)


def fused_mlp_recompute_bwd_reference(config: NeRFConfig, params: dict,
                                      points: torch.Tensor, dy: torch.Tensor) -> dict:
    """Plain PyTorch version of K4 -> the parameter gradients and 'dpts'
    [N, d_in]: the forward again with each layer's bf16 sin and
    bf16(cos10(y)) (fast_sincos's degree-10 cos of the reduced y), then K2's
    gradient math with that bf16 cos as the gate, and K3's point
    cotangent."""
    hs, ys = _stash_layers(config, params, points)
    cs = [_bf(_cos10(y)) for y in ys]
    return _chain_grads(config, params, points, dy, lambda i: hs[i].float(),
                        lambda i: cs[i], lambda i, dz: hs[i].float().t() @ dz, True)


def _core_chunks(rows: torch.Tensor) -> torch.Tensor:
    """B [K, N] float (K a multiple of 32) -> bf16 [K/32, 32 N]: 32-row
    k-chunks, each in wgmma's no-swizzle K-major B layout, element (k, n)
    at ((k // 8) * (N // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8."""
    n = rows.shape[1]
    # (chunk, k group, k, n group, n) -> (chunk, k group, n group, n, k)
    t = rows.to(torch.bfloat16).reshape(-1, _WGMMA_KC // 8, 8, n // 8, 8)
    return t.permute(0, 1, 3, 4, 2).reshape(-1, _WGMMA_KC * n)


def pack_wgmma(w_in: torch.Tensor, w_h: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """w_in [E, H], w_h [L-1, H, H] and w_out [H, O] float -> bf16
    [chunks, 32 H], the wgmma forward's ring chunks in the order it reads
    them: the rows of w_in (zero-padded to a multiple of 32), then of each
    w_h[i], 32 rows a chunk (_core_chunks); then the head, w_out^T with its
    O columns zero-padded to 8, element (k, n) at (k // 8) * 64 + n * 8 +
    k % 8, the chunk zero-padded. The kernel widths fill whole chunks; a
    field of another width (the CPU's plain version reads it back through
    unpack_wgmma) is zero-padded to a multiple of 8 units and its rows to
    whole chunks."""
    e, h = w_in.shape
    pad = -h % 8
    if pad:
        w_in, w_out = F.pad(w_in, (0, pad)), F.pad(w_out, (0, 0, 0, pad))
        w_h = F.pad(w_h, (0, pad, 0, pad))
        h += pad
    k_in = -(-e // _WGMMA_KC) * _WGMMA_KC
    rows = torch.cat([F.pad(w_in, (0, 0, 0, k_in - e)), w_h.reshape(-1, h)])
    layers = _core_chunks(F.pad(rows, (0, 0, 0, -rows.shape[0] % _WGMMA_KC)))
    # (k group, k, n) -> (k group, n, k)
    head = F.pad(w_out.to(torch.bfloat16), (0, MAX_K0_OUTPUTS - w_out.shape[1]))
    head = head.reshape(h // 8, 8, MAX_K0_OUTPUTS).permute(0, 2, 1).reshape(-1)
    head = F.pad(head, (0, _WGMMA_KC * h - head.numel())).reshape(1, -1)
    return torch.cat([layers, head]).contiguous()


def unpack_wgmma(packed: torch.Tensor, d_encoded: int, d_filter: int, n_layers: int,
                 d_output: int) -> tuple:
    """The inverse of pack_wgmma: (w_in [E, H], w_h [L-1, H, H], w_out
    [H, O]) as bf16 tensors, the bf16 roundings of the packed weights."""
    hp = packed.shape[1] // _WGMMA_KC
    # (chunk, k group, n group, n, k) -> (chunk, k group, k, n group, n)
    rows = packed[:-1].reshape(-1, _WGMMA_KC // 8, hp // 8, 8, 8)
    rows = rows.permute(0, 1, 4, 2, 3).reshape(-1, hp)
    k_in = -(-d_encoded // _WGMMA_KC) * _WGMMA_KC
    w_in = rows[:d_encoded, :d_filter]
    w_h = rows[k_in:k_in + (n_layers - 1) * hp].reshape(n_layers - 1, hp, hp)
    head = packed[-1, :hp * MAX_K0_OUTPUTS].reshape(hp // 8, MAX_K0_OUTPUTS, 8)
    w_out = head.permute(0, 2, 1).reshape(hp, MAX_K0_OUTPUTS)
    return w_in, w_h[:, :d_filter, :d_filter], w_out[:d_filter, :d_output]


def pack_wgmma_bwd(w_h: torch.Tensor) -> torch.Tensor:
    """w_h [L-1, H, H] float -> bf16 [(L-1) H/32, 32 H], the chain kernel's
    ring chunks: dh = dz_j w_h[j-1]^T contracts over w_h's output axis, so
    its B operand is w_h[j-1]^T [k = out, n = in], which w_h as stored
    (row-major [in, out]) already holds K-major: layer i's H/32 chunks of
    w_h[i]^T (_core_chunks), in layer order."""
    h = w_h.shape[-1]
    return _core_chunks(w_h.transpose(-1, -2).reshape(-1, h)).contiguous()


def dpts_chunk_cols(d_filter: int) -> int:
    """K3's pack columns a chunk: 128, or H where H is smaller (CW / 32
    whole stages of the chain kernel's ring, H / CW k-chunks [32, CW] each)."""
    return min(_DPTS_COLS, d_filter)


def dpts_layout(d_input: int, dims, d_filter: int) -> tuple:
    """K3's columns, ordered by dimension -> (cols, pairs, gdim). For each
    dimension d in turn its segment [x_d, zero, then (sin_j, cos_j) for each
    phase column j of d (dims[j] == d)], padded with zero columns to whole
    8-column groups and moved to the next half of a chunk (the columns one
    warpgroup of the chain kernel sums) where it would run across one and
    fits in a half; then zero columns up to a multiple of
    dpts_chunk_cols(d_filter). cols[c] is the encoding column (x_d at d,
    sin_j at d_input + j, cos_j at d_input + n_cols + j) behind pack column
    c, -1 for a zero column; pairs[c // 2] what the chain kernel's thread
    holding columns (c, c + 1), c even, sums: j >= 0 the phase j's (dsin,
    dcos), -2 - d the x_d column beside a zero one, -1 zeros; gdim[c // 8]
    the dimension of each 8-column group: that of the segment it belongs
    to, or (padding between segments) of the segment before it, d_input
    for the zero groups after the last."""
    nc = len(dims)
    half = dpts_chunk_cols(d_filter) // 2
    cols, gdim = [], []
    for d in range(d_input):
        seg = [d, -1]
        for j in range(nc):
            if dims[j] == d:
                seg += [d_input + j, d_input + nc + j]
        seg += [-1] * (-len(seg) % 8)
        room = -len(cols) % half
        if len(seg) <= half and len(seg) > room > 0:
            cols += [-1] * room
            gdim += [gdim[-1]] * (room // 8)
        cols += seg
        gdim += [d] * (len(seg) // 8)
    tail = -len(cols) % dpts_chunk_cols(d_filter)
    cols += [-1] * tail
    gdim += [d_input] * (tail // 8)
    pairs = [-1 if a < 0 else -2 - a if a < d_input else a - d_input for a in cols[0::2]]
    return cols, pairs, gdim


def pack_wgmma_dpts(w_in: torch.Tensor, d_input: int, dims) -> torch.Tensor:
    """w_in [E, H] float -> bf16 [n_cc H/32, 32 cw] with cw =
    dpts_chunk_cols(H): the point cotangent's B operand W_in^T [k = H, n =
    pack column], its columns W_in's rows in dpts_layout's order (zero
    where it has -1), as H/32 ring chunks (_core_chunks) for each cw-column
    block in turn."""
    h = w_in.shape[1]
    cw = dpts_chunk_cols(h)
    cols = torch.tensor(dpts_layout(d_input, dims, h)[0], device=w_in.device)
    b = torch.where((cols >= 0)[:, None], w_in.float()[cols.clamp_min(0)], 0.0).t()
    return torch.cat([_core_chunks(b[:, c * cw:(c + 1) * cw].contiguous())
                      for c in range(b.shape[1] // cw)]).contiguous()


def dz_index(pt, j, c, n_layers: int, d_filter: int):
    """Element (point pt, layer j, column c) of the backward's dz scratch
    [tiles][L][64 x H]: tile pt // 64, then layer j's block in wgmma's
    K-major core-matrix order (8 x 8 blocks of 64 contiguous elements, row
    r % 8 at 8 (r % 8), the 8 row groups of a column group in turn), as the
    chain kernel writes it from its shared-memory buffer. Works on ints and
    integer arrays alike."""
    r = pt % _TILE
    core = ((c // 8) * (_TILE // 8) + r // 8) * 64 + (r % 8) * 8 + c % 8
    return ((pt // _TILE) * n_layers + j) * (_TILE * d_filter) + core


def dz_scratch_size(n: int, n_layers: int, d_filter: int) -> int:
    """Elements of the dz scratch for n points (whole tiles)."""
    return -(-n // _TILE) * n_layers * _TILE * d_filter


def unpack_dz_scratch(dz: torch.Tensor, n: int, n_layers: int, d_filter: int) -> torch.Tensor:
    """The dz scratch (flat, dz_index order) -> [n, L*H] row-major, layer
    j's dz_j in columns [j H, (j+1) H)."""
    pt = torch.arange(n, device=dz.device).view(n, 1, 1)
    j = torch.arange(n_layers, device=dz.device).view(1, n_layers, 1)
    c = torch.arange(d_filter, device=dz.device).view(1, 1, d_filter)
    return dz[dz_index(pt, j, c, n_layers, d_filter)].reshape(n, n_layers * d_filter)


def dw_splits(config: NeRFConfig, n: int, e_pad: int, sm_count: int,
              fmt: str = 'int8') -> tuple:
    """(pps, splits): the wgmma dW products' point ranges, `splits` ranges
    of `pps` points (a multiple of 64, the dz scratch's tiles), each with
    its own f32 partials, summed in a fixed order: enough work items for
    about four per SM, and at least 1024 points a range. A range is
    nt (mt0 + (jobs - 1) mt) work items (csrc/fused_mlp_backward.cuh
    dw_plan): 128-row tiles of dW_in's e_pad rows (mt0) and of each dW_h's
    H (mt) by TN-column tiles of H (nt, TN = 256, 128 or 64, the largest
    that divides H), over jobs = L (dW_in and the L - 1 dW_h), or 1 for
    'i8pair', whose dW_h the int8 kernel takes (dw_i8_splits)."""
    H = config.d_filter
    jobs = 1 if fmt == 'i8pair' else config.n_layers
    nt = H // (256 if H % 256 == 0 else 128 if H % 128 == 0 else 64)
    per_split = nt * (-(-e_pad // _DW_ROWS) + (jobs - 1) * -(-H // _DW_ROWS))
    splits = max(1, min(-(-4 * sm_count // per_split), -(-n // 1024)))
    pps = -(-(-(-n // splits)) // _TILE) * _TILE
    return pps, -(-n // pps)


I8_MAX_SPLITS = 8       # 'i8pair' dW_h ranges at most (7.3 MB of partials each at 8x512)


def dw_i8_splits(config: NeRFConfig, n: int, group: int, sm_count: int) -> tuple:
    """'i8pair': (pps8, splits8), the int8 dW_h kernel's point ranges:
    `splits8` ranges of `pps8` points, each whole scale groups and whole
    64-point tiles (pps8 a multiple of lcm(64, group)), each with its own
    f32 partials of the L - 1 dW_h. A range is (L - 1) ceil(H / 128) (H /
    TN) work items (TN = 128, or 64 at H = 64; csrc/fused_mlp_backward.cuh
    dw_i8_wgmma_kernel) walked by one block an SM: the count, up to
    I8_MAX_SPLITS, whose items fill the SMs' last wave best, the fewer on a
    tie (7 at 8x512, N = 262,144 on 132 SMs: 784 items, 5.94 waves)."""
    H, L = config.d_filter, config.n_layers
    tn = 128 if H % 128 == 0 else 64
    per_split = max(L - 1, 1) * -(-H // 128) * (H // tn)
    unit = _TILE * group // math.gcd(_TILE, group)
    best = None
    for want in range(1, I8_MAX_SPLITS + 1):
        pps = -(-(-(-n // want)) // unit) * unit
        splits = -(-n // pps)
        items = splits * per_split
        fill = items / (-(-items // sm_count) * sm_count)
        if best is None or fill > best[0]:
            best = (fill, pps, splits)
    return best[1], best[2]


@dataclasses.dataclass(frozen=True, eq=False)
class _KernelWeights:
    """One parameter set as the kernels read it (device tensors), beside the
    wgmma packs (_wgmma_weights, _bwd_weights, _dpts_weights)."""
    col_dim: torch.Tensor     # [n_cols] int32
    col_freq: torch.Tensor    # [n_cols] f32
    b_in: torch.Tensor        # [H] f32
    b_h: torch.Tensor         # [L-1, H] f32
    w_out: torch.Tensor       # [d_out, H] bf16
    b_out: torch.Tensor       # [d_out] f32
    w_grid: torch.Tensor      # pack_wgmma_grid of w_in's grid rows (K2), or None
    e_pad: int


def _prepare(config: NeRFConfig, params: dict) -> _KernelWeights:
    col_dim, col_freq = _columns(config, params['w_in'].device)
    e_pad = -(-config.d_encoded // 16) * 16
    off = _grid_offset(config)
    with torch.no_grad():
        return _KernelWeights(
            col_dim=col_dim, col_freq=col_freq,
            b_in=params['b_in'].float().contiguous(),
            b_h=params['b_h'].float().contiguous(),
            w_out=params['w_out'].t().to(torch.bfloat16).contiguous(),
            b_out=params['b_out'].float().contiguous(),
            w_grid=(pack_wgmma_grid(params['w_in'][off:off + config.d_grid])
                    if config.grid_sizes else None),
            e_pad=e_pad)


def _version(t: torch.Tensor) -> int:
    return -1 if t.is_inference() else t._version


def _kernel_weights(config: NeRFConfig, params: dict) -> _KernelWeights:
    """Packed weights of this parameter set, prepared once and reused while
    the same tensors, unmodified, come back."""
    stamp = (config,) + tuple((id(params[k]), _version(params[k])) for k in _KEYS)
    hit = _prepared.get(params['w_in'])
    if hit is None or hit[0] != stamp:
        hit = (stamp, _prepare(config, params))
        _prepared[params['w_in']] = hit
    return hit[1]


def _dpts_weights(config: NeRFConfig, w_in: torch.Tensor) -> tuple:
    """(pack_wgmma_dpts of w_in, dpts_layout's pairs and gdim as int32), on
    w_in's device, prepared only for the backwards that compute the point
    cotangent (K3, K4) and cached like _kernel_weights."""
    stamp = (config, id(w_in), _version(w_in))
    hit = _prepared_dpts.get(w_in)
    if hit is None or hit[0] != stamp:
        dims, _ = encoding_columns(config.d_input, config.n_freqs, config.scale_factor,
                                   config.n_freqs_time)
        _, pairs, gdim = dpts_layout(config.d_input, dims, config.d_filter)
        i32 = dict(dtype=torch.int32, device=w_in.device)
        with torch.no_grad():
            hit = (stamp, (pack_wgmma_dpts(w_in.float(), config.d_input, dims),
                           torch.tensor(pairs, **i32), torch.tensor(gdim, **i32)))
        _prepared_dpts[w_in] = hit
    return hit[1]


def _bwd_weights(w_h: torch.Tensor) -> torch.Tensor:
    """pack_wgmma_bwd of w_h, prepared only for the backwards and cached
    like _kernel_weights."""
    stamp = (id(w_h), _version(w_h))
    hit = _prepared_bwd.get(w_h)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, pack_wgmma_bwd(w_h.float()))
        _prepared_bwd[w_h] = hit
    return hit[1]


def _wgmma_weights(params: dict) -> torch.Tensor:
    """pack_wgmma of this parameter set, the forwards' weights, cached like
    _kernel_weights."""
    stamp = tuple((id(params[k]), _version(params[k])) for k in ('w_in', 'w_h', 'w_out'))
    hit = _prepared_wgmma.get(params['w_in'])
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, pack_wgmma(params['w_in'].float(), params['w_h'].float(),
                                     params['w_out'].float()))
        _prepared_wgmma[params['w_in']] = hit
    return hit[1]


def kernel_width(d_filter: int) -> int:
    """The width a field of d_filter runs at in the kernels: d_filter when
    it is one of KERNEL_WIDTHS, else the next larger one. Above the largest
    (512) there is none: ValueError."""
    for width in KERNEL_WIDTHS:
        if d_filter <= width:
            return width
    raise ValueError(f'the fused kernels take d_filter up to {KERNEL_WIDTHS[-1]} '
                     f'(the widest kernel width), got {d_filter}')


def kernel_route(config: NeRFConfig, backward: bool = False) -> str:
    """'fused' where every limit of the fused kernels holds (d_filter up to
    KERNEL_WIDTHS[-1], d_output in 1..MAX_K0_OUTPUTS for a forward and in
    1..MAX_BWD_OUTPUTS where a backward will run), else 'wide': the
    per-layer kernels of ops/wide_mlp.py, which take any width and output
    count. A field that trains takes one route for its forward and its
    backward (backward=True for both)."""
    outputs = MAX_BWD_OUTPUTS if backward else MAX_K0_OUTPUTS
    if config.d_filter <= KERNEL_WIDTHS[-1] and 1 <= config.d_output <= outputs:
        return 'fused'
    return 'wide'


def _route_field(config: NeRFConfig, params: dict, route: str) -> tuple:
    """The field padded for its route's kernels: kernel_width ('fused') or
    wide_width ('wide')."""
    if route == 'wide':
        return _kernel_field(config, params, wide_mlp.wide_width(config.d_filter))
    return _kernel_field(config, params)


def check_kernel_config(config: NeRFConfig):
    """Raises ValueError, naming the count, for a field that no kernel can
    take on the card: d_filter or d_output below 1. Every other field runs
    on the card, on the fused kernels or the wide route (kernel_route).
    systems' _select_apply calls it where a field's CUDA path is chosen (so
    the loaders and the Trainer refuse such a field before any tensor is
    made): a field converted from outside (utils/snf_converter) may have
    any width and output count."""
    if config.d_filter < 1:
        raise ValueError(f'the kernels take d_filter from 1, got {config.d_filter}')
    if config.d_output < 1:
        raise ValueError(f'the kernels take d_output from 1, got {config.d_output}')


def pad_field(config: NeRFConfig, params: dict, width: int = None) -> tuple:
    """(config, params) of the same field zero-padded to `width` units
    (by default kernel_width(d_filter); the wide route's wide_width):
    w_in's columns, b_in, both hidden axes of w_h, b_h and w_out's
    rows. A padded unit has pre-activation 0 and sin 0, and its outgoing
    weights are 0, so it adds nothing to the next layer and the cotangent
    reaching it is 0: the field and the real entries' gradients are
    unchanged. The pads are F.pad, so under autograd the gradients of the
    caller's tensors come back sliced to their shapes. Grid tables and
    other keys pass through. A field of a kernel width is returned as it
    is."""
    width = kernel_width(config.d_filter) if width is None else width
    if width == config.d_filter:
        return config, params
    pad = width - config.d_filter
    padded = dict(params)
    padded.update(w_in=F.pad(params['w_in'], (0, pad)),
                  b_in=F.pad(params['b_in'], (0, pad)),
                  w_h=F.pad(params['w_h'], (0, pad, 0, pad)),
                  b_h=F.pad(params['b_h'], (0, pad)),
                  w_out=F.pad(params['w_out'], (0, 0, 0, pad)))
    return dataclasses.replace(config, d_filter=width), padded


def _kernel_field(config: NeRFConfig, params: dict, width: int = None) -> tuple:
    """pad_field for the kernels, to `width` (by default kernel_width). A
    field that needs gradients is padded afresh, through autograd, on every
    call (one copy of its weights); one that does not (a render) is padded
    once and reused while the same tensors, unmodified, come back, as the
    packed weights are."""
    width = kernel_width(config.d_filter) if width is None else width
    if width == config.d_filter:
        return config, params
    keys = param_keys(config)
    if torch.is_grad_enabled() and any(params[k].requires_grad for k in keys):
        return pad_field(config, params, width)
    stamp = (config,) + tuple((id(params[k]), _version(params[k])) for k in keys)
    hit = _padded.get(params['w_in'])
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, pad_field(config, params, width))
        _padded[params['w_in']] = hit
    return hit[1]


def _check(config: NeRFConfig, params: dict, points: torch.Tensor):
    if points.device.type != 'cuda':
        raise ValueError(f'no fused kernel for device {points.device}')
    if config.grid_rank:
        raise NotImplementedError(_NO_VM_KERNEL)
    if min(config.grid_sizes, default=2) < 2:
        raise ValueError(f'the fused kernels take grid levels of 2 or more cells '
                         f'a side, got {config.grid_sizes}')
    if config.d_filter not in KERNEL_WIDTHS:
        raise ValueError(f'the kernels take d_filter in {KERNEL_WIDTHS}, got '
                         f'{config.d_filter}: fused_mlp_forward pads other widths '
                         f'(pad_field)')
    if not 1 <= config.d_output <= MAX_K0_OUTPUTS:
        raise ValueError(f'the fused forward takes d_output from 1 to {MAX_K0_OUTPUTS}, '
                         f'got {config.d_output}')
    if points.dtype != torch.float32 or points.dim() != 2 \
            or points.shape[1] != config.d_input:
        raise ValueError(f'points must be float32 [N, {config.d_input}], got '
                         f'{points.dtype} {list(points.shape)}')
    if not points.is_contiguous():
        raise ValueError('points must be contiguous')
    for k in _KEYS:
        if params[k].device != points.device:
            raise ValueError(f'params[{k!r}] is on {params[k].device}, points '
                             f'on {points.device}')
    for k, g in zip(grid_keys(config), config.grid_sizes):
        build.check_tensor(f'params[{k!r}]', params[k], (g, g, g, config.grid_features),
                           torch.float32, points.device)


class _GridArgs(ctypes.Structure):
    """GridParams of csrc/fused_mlp_common.cuh, passed by pointer; `levels`
    is grid_descriptors' device array."""
    _fields_ = [('levels', ctypes.c_void_p),
                ('total', ctypes.c_longlong),
                ('n_levels', ctypes.c_int),
                ('features', ctypes.c_int),
                ('bound', ctypes.c_float),
                ('vec4', ctypes.c_int)]


_grid_descriptors: dict = {}


def grid_offsets(config: NeRFConfig) -> list:
    """Each level's first element in the flat d_table (and the fixed-point
    sums), the levels' G^3 F elements in grid_keys order, and the total
    last: [0, G_0^3 F, ..., sum G^3 F]."""
    offsets = [0]
    for g in config.grid_sizes:
        offsets.append(offsets[-1] + g ** 3 * config.grid_features)
    return offsets


def grid_descriptors(config: NeRFConfig, params: dict) -> torch.Tensor:
    """int64 [levels, 3]: per level (the table's address, its offset in
    d_table, G), GridLevel of csrc/fused_mlp_common.cuh, on the tables'
    device: the kernels read it by pointer, so any number of levels fits.
    Made once per set of table addresses and kept (an optimizer's in-place
    update keeps the addresses)."""
    return _level_descriptors([params[k] for k in grid_keys(config)], config.grid_features)


def _level_descriptors(tables: list, features: int) -> torch.Tensor:
    dev = tables[0].device
    sizes = tuple(t.shape[0] for t in tables)
    key = (dev, sizes, features) + tuple(t.data_ptr() for t in tables)
    hit = _grid_descriptors.get(key)
    if hit is None:
        offsets = np.cumsum([0] + [g ** 3 * features for g in sizes]).tolist()
        rows = [[t.data_ptr(), offsets[i], g] for i, (t, g) in enumerate(zip(tables, sizes))]
        hit = torch.tensor(rows, dtype=torch.int64).to(dev)
        if len(_grid_descriptors) >= 64:
            _grid_descriptors.clear()
        _grid_descriptors[key] = hit
    return hit


GRID_SCATTER_LANES = 4   # grid_scatter_kernel's lanes a (point, level)


def grid_scatter_item(t, n: int):
    """(point, level, first feature) of grid_scatter_kernel's thread t for n
    points: a quad of lanes a (point, level), quad t // 4 taking level
    (t // 4) // n and point (t // 4) % n, lane t % 4 its features t % 4,
    t % 4 + 4, ...; so a warp holds 8 consecutive points of one level.
    Works on ints and integer arrays alike."""
    item = t // GRID_SCATTER_LANES
    return item % n, item // n, t % GRID_SCATTER_LANES


def pack_wgmma_grid(w_grid: torch.Tensor) -> torch.Tensor:
    """w_in's grid rows [levels F, H] float -> bf16 [n_gc H/32, 32 * 32]:
    the grid cotangent's B operand W_in[grid rows]^T [k = H, n = grid
    column], its columns zero-padded to whole blocks of GRID_STAGE_COLS, as
    H/32 ring chunks (_core_chunks) for each block in turn: one block is
    one ring stage of the chain kernel."""
    b = w_grid.float().t()
    b = F.pad(b, (0, -b.shape[1] % GRID_STAGE_COLS))
    return torch.cat([_core_chunks(b[:, c:c + GRID_STAGE_COLS].contiguous())
                      for c in range(0, b.shape[1], GRID_STAGE_COLS)]).contiguous()


def _grid_args(config: NeRFConfig, params: dict) -> _GridArgs:
    """The live float32 tables (checked by _check) as the kernels take
    them; the caller keeps `params` alive over the launch."""
    return _grid_args_of([params[k] for k in grid_keys(config)], config.grid_features,
                         config.grid_bound)


def _grid_args_of(tables: list, features: int, bound: float) -> _GridArgs:
    args = _GridArgs()
    if not tables:
        return args
    args.levels = _level_descriptors(tables, features).data_ptr()
    args.total = sum(t.numel() for t in tables)
    args.n_levels = len(tables)
    args.features = features
    args.bound = bound
    args.vec4 = int(features % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tables))
    return args


def _launch(name: str, n_ptrs: int, n_ints: int, device, *args, defines: tuple = ()):
    build.launch(name, build.signature(n_ptrs, n_ints), device, *args, defines=defines)


def _fwd_args(w: _KernelWeights, params: dict, points, grid: _GridArgs, out):
    return (points.data_ptr(), w.col_dim.data_ptr(), w.col_freq.data_ptr(),
            _wgmma_weights(params).data_ptr(), w.b_in.data_ptr(), w.b_h.data_ptr(),
            w.b_out.data_ptr(), ctypes.addressof(grid), out.data_ptr())


def _fwd_ints(config, w: _KernelWeights, n: int):
    return (n, config.d_input, w.col_dim.numel(), w.e_pad, config.d_filter,
            config.n_layers - 1, config.d_output)


def _count_grid(config: NeRFConfig):
    global GRID_LAUNCHES
    if config.grid_sizes:
        GRID_LAUNCHES += 1


GRID_KERNELS = ('prep_grid_kernel', 'grid_scatter_kernel', 'grid_convert_kernel')
# the kernels whose launches a library counts itself, by library, in the
# order of its sunerf_kernel_launches: K0's, K5's own kernels in the
# stashing backward, and the wide route's (ops/wide_mlp.py): its forwards by
# format and its kernels, its backwards by format and its kernels
COUNTED_KERNELS = {
    'fused_mlp_fwd_wgmma': ('fwd_wgmma_kernel',),
    'fused_mlp_stash_bwd': GRID_KERNELS,
    'wide_mlp_fwd': ('wide_fwd (K0)', 'wide_fwd (K1)', 'wide_fwd (K6a)', 'wide_fwd (K6b)',
                     'wide_fwd (K4)', 'encode_kernel', 'wide_wgmma_kernel'),
    'wide_mlp_bwd': ('wide_bwd (K2)', 'wide_bwd (K6a)', 'wide_bwd (K6b)', 'wide_bwd (K4)',
                     'wide_wgmma_kernel chain', 'wide_wgmma_kernel dW', 'dpts_kernel (K3)',
                     'grid_max_kernel (K5)', 'wide_dw_i8_wgmma_kernel (K6b)',
                     'wide_wgmma_kernel denc', 'wide_dz_group_max_kernel (K6b)')}


def kernel_launches(library: str) -> dict:
    """The kernels of COUNTED_KERNELS[library] by name: their launches by
    the built library csrc/<library>.cu since it was loaded, as its
    launchers count them where each launch returned no error (an exported
    program's K0 launches included, which the wrapper's LAUNCHES does not
    see). Builds the library on first use (needs nvcc)."""
    names = COUNTED_KERNELS[library]
    fn = build.load(library).sunerf_kernel_launches
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(names))()
    fn(ctypes.addressof(out))
    return dict(zip(names, out))


_column_cache: dict = {}


def _columns(config: NeRFConfig, device) -> tuple:
    """(col_dim int32, col_freq f32) of the encoding's sin/cos columns on
    `device`, made once per config and device."""
    key = (config.d_input, config.n_freqs, config.scale_factor, config.n_freqs_time,
           str(torch.device(device)))
    hit = _column_cache.get(key)
    if hit is None:
        dims, freqs = encoding_columns(*key[:4])
        hit = _column_cache[key] = (
            torch.tensor(dims, dtype=torch.int32, device=device),
            torch.tensor(freqs, dtype=torch.float32, device=device))
    return hit


def k0_operands(config: NeRFConfig, params: dict) -> dict:
    """K0's operands for this field as fused_mlp_fwd takes them, on the
    params' device: the packed weights (pack_wgmma, made once per parameter
    set and cached like _kernel_weights), the encoding's columns, the
    float32 biases and the grid tables (live). A render passes them to the
    op on every call; an exported program holds them as constants."""
    col_dim, col_freq = _columns(config, params['w_in'].device)
    with torch.no_grad():
        return dict(weights=_wgmma_weights(params), col_dim=col_dim, col_freq=col_freq,
                    b_in=params['b_in'].float().contiguous(),
                    b_h=params['b_h'].float().contiguous(),
                    b_out=params['b_out'].float().contiguous(),
                    grids=[params[k] for k in grid_keys(config)])


def k0_field_operands(config: NeRFConfig, params: dict) -> tuple:
    """(config, operands) of a field for a program that calls the forward's
    registered op itself (an export): k0_operands for fused_mlp_fwd, or on
    the wide route (kernel_route) wide_mlp.wide_operands for wide_mlp_fwd;
    fused_mlp_packed calls the one its operands are for. On CUDA the field
    is zero-padded to its route's width and checked as the forward checks
    it, so the program's operands are what the kernel takes; on the CPU as
    it is."""
    if config.grid_rank:
        raise NotImplementedError(_NO_VM_KERNEL)
    check_kernel_config(config)
    dev = params['w_in'].device
    route = kernel_route(config)
    if dev.type == 'cuda':
        config, params = _route_field(config, params, route)
        check = wide_mlp._check if route == 'wide' else _check
        check(config, params, torch.empty((0, config.d_input), device=dev))
    if route == 'wide':
        return config, wide_mlp.wide_operands(config, params)
    return config, k0_operands(config, params)


@torch.library.custom_op('sunerf_tpu_torch::fused_mlp_fwd', mutates_args=())
def fused_mlp_fwd(points: torch.Tensor, weights: torch.Tensor, col_dim: torch.Tensor,
                  col_freq: torch.Tensor, b_in: torch.Tensor, b_h: torch.Tensor,
                  b_out: torch.Tensor, grids: list[torch.Tensor],
                  grid_bound: float) -> torch.Tensor:
    """K0 as a registered op, sunerf_tpu_torch::fused_mlp_fwd: raw [N,
    d_output] f32 of the field at points [N, d_input], base offsets
    excluded, from k0_operands. The dims come from the operands' shapes
    (d_filter = b_in's, L - 1 = b_h's rows, d_output = b_out's, F = the
    tables' last axis); grid_bound is the one argument besides tensors. On
    CUDA tensors it launches csrc/fused_mlp_fwd_wgmma.cu (or raises); on
    any other device it is K0's plain version, which reads the weights back
    with unpack_wgmma (bf16 values, so the same bits as
    fused_mlp_reference)."""
    e = points.shape[1] + 2 * col_dim.numel() + sum(t.shape[-1] for t in grids)
    w_in, w_h, w_out = unpack_wgmma(weights, e, b_in.numel(), b_h.shape[0] + 1,
                                    b_out.numel())
    h = _encode_columns(points, col_dim.long(), col_freq, list(grids), grid_bound)
    for w, b in [(w_in, b_in)] + list(zip(w_h, b_h)):
        h = reduced_sin(_mm(h, w.contiguous()) + b)
    return _mm(h, w_out.contiguous()) + b_out


@fused_mlp_fwd.register_fake
def _fused_mlp_fwd_fake(points, weights, col_dim, col_freq, b_in, b_h, b_out, grids,
                        grid_bound):
    return points.new_empty((points.shape[0], b_out.shape[0]))


@fused_mlp_fwd.register_kernel('cuda')
def _fused_mlp_fwd_cuda(points, weights, col_dim, col_freq, b_in, b_h, b_out, grids,
                        grid_bound):
    return _launch_k0(points, weights, col_dim, col_freq, b_in, b_h, b_out, list(grids),
                      grid_bound)


def _launch_k0(points, weights, col_dim, col_freq, b_in, b_h, b_out, grids: list,
               grid_bound: float, defines: tuple = ()) -> torch.Tensor:
    """Launches csrc/fused_mlp_fwd_wgmma.cu on fused_mlp_fwd's operands,
    checked as the kernel reads them; the _GridArgs structure is made here,
    at call time, from the tables' addresses."""
    n, d_input = points.shape
    dev = points.device
    h, d_output, hidden = b_in.numel(), b_out.numel(), b_h.shape[0]
    features = grids[0].shape[-1] if grids else 0
    e = d_input + 2 * col_dim.numel() + len(grids) * features
    chunks = -(-e // _WGMMA_KC) + hidden * h // _WGMMA_KC + 1
    f32 = torch.float32
    for name, t, shape, dtype in (
            ('points', points, (n, d_input), f32),
            ('weights', weights, (chunks, _WGMMA_KC * h), torch.bfloat16),
            ('col_dim', col_dim, col_dim.shape, torch.int32),
            ('col_freq', col_freq, col_dim.shape, f32), ('b_in', b_in, (h,), f32),
            ('b_h', b_h, (hidden, h), f32), ('b_out', b_out, (d_output,), f32),
            *((f'grids[{i}]', t, (t.shape[0],) * 3 + (features,), f32)
              for i, t in enumerate(grids))):
        build.check_tensor(name, t, shape, dtype, dev)
    out = torch.empty((n, d_output), dtype=f32, device=dev)
    if n == 0:
        return out
    grid = _grid_args_of(grids, features, grid_bound)
    _launch('fused_mlp_fwd_wgmma', 9, 7, dev, points.data_ptr(), col_dim.data_ptr(),
            col_freq.data_ptr(), weights.data_ptr(), b_in.data_ptr(), b_h.data_ptr(),
            b_out.data_ptr(), ctypes.addressof(grid), out.data_ptr(),
            n, d_input, col_dim.numel(), -(-e // 16) * 16, h, hidden, d_output,
            defines=defines)
    return out


def fused_mlp_packed(ops: dict, points: torch.Tensor, grid_bound: float) -> torch.Tensor:
    """fused_mlp_fwd on k0_operands' dict, or wide_mlp_fwd on
    wide_operands': the call an exported program makes, its operands baked
    in."""
    if 'w_in_t' in ops:
        return wide_mlp.wide_mlp_packed(ops, points, grid_bound)
    return fused_mlp_fwd(points, ops['weights'], ops['col_dim'], ops['col_freq'],
                         ops['b_in'], ops['b_h'], ops['b_out'], ops['grids'], grid_bound)


def _tracing() -> bool:
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def _forward_k0(config: NeRFConfig, params: dict,
                points: torch.Tensor, defines: tuple = (), backward: bool = False) -> torch.Tensor:
    """The K0 wrapper: the registered op fused_mlp_fwd on this field's
    k0_operands; CUDA tensors launch csrc/fused_mlp_fwd_wgmma.cu (or
    raise), CPU tensors run its plain version. It counts a launch here, in
    eager calls only (an exported program runs the op without this
    wrapper). `defines` launches a variant built with those macros, outside
    the op (scripts/backward_ablation.py's measurement-only ablations).
    A field on the wide route (kernel_route(config, backward)) runs
    wide_mlp.wide_forward instead."""
    global LAUNCHES
    if kernel_route(config, backward) == 'wide':
        return wide_mlp.wide_forward(config, params, points)
    cuda = points.device.type == 'cuda'
    if cuda:
        _check(config, params, points)
    ops = k0_operands(config, params)
    if defines:
        return _launch_k0(points, *(ops[k] for k in ('weights', 'col_dim', 'col_freq',
                                                     'b_in', 'b_h', 'b_out', 'grids')),
                          config.grid_bound, defines=defines)
    out = fused_mlp_packed(ops, points, config.grid_bound)
    if cuda and points.shape[0] and not _tracing():
        LAUNCHES += 1
        _count_grid(config)
    return out


def _count_format(fmt: str):
    global LSB_LAUNCHES, I8PAIR_LAUNCHES
    if fmt == 'lsb':
        LSB_LAUNCHES += 1
    elif fmt == 'i8pair':
        I8PAIR_LAUNCHES += 1


def _check_format(config: NeRFConfig, fmt: str):
    if fmt not in STASH_FORMATS:
        raise ValueError(f'stash_format must be one of {STASH_FORMATS}, got {fmt!r}')
    if config.grid_sizes and fmt != 'int8':
        raise NotImplementedError(f'grid-encoding configs support the int8 stash '
                                  f'only, got {fmt!r}')


def _stash_shapes(config: NeRFConfig, n: int, fmt: str) -> dict:
    """The stash tensors' (shape, dtype) of each format."""
    lh = config.n_layers * config.d_filter
    return {'int8': ((n, lh), torch.bfloat16, (n, lh), torch.int8),
            'lsb': ((n, lh), torch.bfloat16, None, None),
            'i8pair': ((n, 2 * lh), torch.int8, None, None)}[fmt]


def fused_mlp_stash_forward(config: NeRFConfig, params: dict,
                            points: torch.Tensor, fmt: str = 'int8'):
    """The stashing forward's wrapper (K1 'int8', K6a 'lsb', K6b 'i8pair')
    -> (out [N, d_out] f32, hs, cs) as fused_mlp_stash_reference returns
    them. CUDA tensors launch the kernel (or raise), CPU tensors run its
    plain version. A field on the wide route runs
    wide_mlp.wide_stash_forward."""
    global STASH_FWD_LAUNCHES
    _check_format(config, fmt)
    if kernel_route(config, backward=True) == 'wide':
        return wide_mlp.wide_stash_forward(config, params, points, fmt)
    if points.device.type == 'cpu':
        return fused_mlp_stash_reference(config, params, points, fmt)
    _check(config, params, points)
    n, dev = points.shape[0], points.device
    hs_shape, hs_dtype, cs_shape, cs_dtype = _stash_shapes(config, n, fmt)
    out = torch.empty((n, config.d_output), dtype=torch.float32, device=dev)
    hs = torch.empty(hs_shape, dtype=hs_dtype, device=dev)
    cs = None if cs_shape is None else torch.empty(cs_shape, dtype=cs_dtype, device=dev)
    if n == 0:
        return out, hs, cs
    w = _kernel_weights(config, params)
    grid = _grid_args(config, params)
    _launch('fused_mlp_stash_fwd', 11, 8, dev, *_fwd_args(w, params, points, grid, out),
            hs.data_ptr(), None if cs is None else cs.data_ptr(),
            *_fwd_ints(config, w, n), _FMT_CODE[fmt])
    STASH_FWD_LAUNCHES += 1
    _count_grid(config)
    _count_format(fmt)
    return out, hs, cs


def _grads_from_flat(config: NeRFConfig, grad_chain: torch.Tensor,
                     grad_dw: torch.Tensor, grad_grid: torch.Tensor,
                     e_pad: int) -> dict:
    """The backwards' f32 output buffers -> gradients in the JAX layout
    (views)."""
    H, L, O = config.d_filter, config.n_layers, config.d_output
    db = grad_chain[O * H + O:].view(L, H)
    grads = {'w_in': grad_dw[:e_pad * H].view(e_pad, H)[:config.d_encoded],
             'b_in': db[0],
             'w_h': grad_dw[e_pad * H:].view(L - 1, H, H),
             'b_h': db[1:],
             'w_out': grad_chain[:O * H].view(H, O),
             'b_out': grad_chain[O * H:O * H + O]}
    offsets = grid_offsets(config)
    for i, (k, g) in enumerate(zip(grid_keys(config), config.grid_sizes)):
        grads[k] = grad_grid[offsets[i]:offsets[i + 1]].view(g, g, g, config.grid_features)
    return grads


def _check_backward(config: NeRFConfig, dy: torch.Tensor, n: int, dev):
    if not 1 <= config.d_output <= MAX_BWD_OUTPUTS:
        raise ValueError(f'the backward kernels take d_output in 1..'
                         f'{MAX_BWD_OUTPUTS}, got {config.d_output}')
    build.check_tensor('dy', dy, (n, config.d_output), torch.float32, dev)


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_group(group: int):
    """The i8pair scale group on the card: any group whose int32 sums
    cannot overflow."""
    if group < 1 or group * 127 * 127 >= 2 ** 31:
        raise ValueError(f'the i8pair kernel takes stash_bwd_tile from 1 to '
                         f'{(2 ** 31 - 1) // 127 ** 2}, got {group}')


def fused_mlp_stash_backward(config: NeRFConfig, params: dict,
                             points: torch.Tensor, dy: torch.Tensor,
                             hs: torch.Tensor, cs, fmt: str = 'int8',
                             compute_dpts: bool = False,
                             group: int = STASH_BWD_TILE) -> dict:
    """The stashing backward's wrapper (K2, with K3 for compute_dpts, K6a
    'lsb', K6b 'i8pair' with its dz scale group of `group` points) ->
    parameter gradients in the JAX layout and, with compute_dpts, 'dpts'
    (see fused_mlp_stash_bwd_reference). CUDA tensors launch the kernels
    (or raise), CPU tensors run their plain version. A field on the wide
    route runs wide_mlp.wide_stash_backward."""
    global STASH_BWD_LAUNCHES, DPTS_LAUNCHES
    _check_format(config, fmt)
    if compute_dpts and config.grid_sizes:
        raise NotImplementedError(_NO_GRID_DPTS)
    if kernel_route(config, backward=True) == 'wide':
        return wide_mlp.wide_stash_backward(config, params, points, dy, hs, cs, fmt,
                                            compute_dpts, group)
    if points.device.type == 'cpu':
        return fused_mlp_stash_bwd_reference(config, params, points, dy, hs, cs, fmt,
                                             compute_dpts, group)
    grads, _ = _stash_backward_launch(config, params, points, dy, hs, cs, fmt, compute_dpts,
                                      group)
    STASH_BWD_LAUNCHES += 1
    _count_grid(config)
    _count_format(fmt)
    if compute_dpts:
        DPTS_LAUNCHES += 1
    return grads


def _stash_backward_launch(config: NeRFConfig, params: dict, points: torch.Tensor,
                           dy: torch.Tensor, hs: torch.Tensor, cs, fmt: str,
                           compute_dpts: bool, group: int, defines: tuple = ()):
    """Launches the stashing backward on CUDA tensors -> (gradients, the dz
    scratch), the scratch flat in dz_index order (None for n = 0).
    `defines` launches a variant of the kernels built with those macros
    (scripts/backward_ablation.py's measurement-only ablations)."""
    _check(config, params, points)
    dev = points.device
    n, H, L, O = points.shape[0], config.d_filter, config.n_layers, config.d_output
    _check_backward(config, dy, n, dev)
    hs_shape, hs_dtype, cs_shape, cs_dtype = _stash_shapes(config, n, fmt)
    build.check_tensor('hs', hs, hs_shape, hs_dtype, dev)
    if cs_shape is not None:
        build.check_tensor('cs', cs, cs_shape, cs_dtype, dev)
    if fmt == 'i8pair':
        _check_group(group)
    w = _kernel_weights(config, params)
    e_pad = w.e_pad
    f32 = dict(dtype=torch.float32, device=dev)
    grad_chain = torch.empty(O * H + O + L * H, **f32)
    grad_dw = torch.empty(e_pad * H + (L - 1) * H * H, **f32)
    n_table = grid_offsets(config)[-1]
    grad_grid = torch.empty(n_table, **f32)
    dpts = torch.empty((n, config.d_input), **f32) if compute_dpts else None
    if n == 0:
        for t in (grad_chain, grad_dw, grad_grid):
            t.zero_()
        grads = _grads_from_flat(config, grad_chain, grad_dw, grad_grid, e_pad)
        return (dict(grads, dpts=dpts) if compute_dpts else grads), None
    pps, splits = dw_splits(config, n, e_pad, _sm_count(dev), fmt)
    dz = torch.empty(dz_scratch_size(n, L, H), dtype=torch.bfloat16, device=dev)
    enc = torch.empty((n, e_pad), dtype=torch.bfloat16, device=dev)
    part_chain = torch.empty((-(-n // _TILE), grad_chain.numel()), **f32)
    if fmt == 'i8pair':
        # dW_in's partials [splits][e_pad H], then the int8 kernel's dW_h
        # partials [splits8][(L-1) H^2]
        pps8, splits8 = dw_i8_splits(config, n, group, _sm_count(dev))
        part_dw = torch.empty(splits * e_pad * H + splits8 * (L - 1) * H * H, **f32)
    else:
        pps8 = splits8 = 0
        part_dw = torch.empty((splits, grad_dw.numel()), **f32)
    grid = _grid_args(config, params)
    # K5 scratch: the grid cotangent, each level's max |.| (as float bits)
    # and the fixed-point sums, the last two zeroed
    dgrid = torch.empty((n, config.d_grid), **f32)
    gmax = torch.zeros(len(config.grid_sizes), dtype=torch.int32, device=dev)
    gacc = torch.zeros(n_table, dtype=torch.int64, device=dev)
    # i8pair: each point's and each group's max |dz_j| of the hidden layers
    dz_rowmax, dz_max = ((torch.empty((max(L - 1, 1), n, 2), **f32),
                          torch.empty((-(-n // group), max(L - 1, 1)), **f32))
                         if fmt == 'i8pair' else (None, None))
    ptr = (lambda t: None if t is None else t.data_ptr())
    w_dpts, pairs, gdim = (_dpts_weights(config, params['w_in']) if compute_dpts
                           else (None, None, None))
    _launch('fused_mlp_stash_bwd', 26, 14, dev,
            points.data_ptr(), w.col_dim.data_ptr(), w.col_freq.data_ptr(),
            dy.data_ptr(), hs.data_ptr(), ptr(cs), _bwd_weights(params['w_h']).data_ptr(),
            w.w_out.data_ptr(), dz.data_ptr(), enc.data_ptr(),
            part_chain.data_ptr(), part_dw.data_ptr(), grad_chain.data_ptr(),
            grad_dw.data_ptr(), ctypes.addressof(grid), ptr(w.w_grid),
            dgrid.data_ptr(), gmax.data_ptr(), gacc.data_ptr(), grad_grid.data_ptr(),
            ptr(dpts), ptr(w_dpts), ptr(pairs), ptr(gdim), ptr(dz_rowmax), ptr(dz_max),
            n, config.d_input, w.col_dim.numel(), e_pad, H, L - 1, O, pps, splits,
            pps8, splits8, _FMT_CODE[fmt], group, 0 if gdim is None else 8 * gdim.numel(),
            defines=defines)
    grads = _grads_from_flat(config, grad_chain, grad_dw, grad_grid, e_pad)
    if compute_dpts:
        grads['dpts'] = dpts
    return grads, dz


def fused_mlp_recompute_backward(config: NeRFConfig, params: dict,
                                 points: torch.Tensor, dy: torch.Tensor) -> dict:
    """The K4 wrapper -> parameter gradients and 'dpts' (see
    fused_mlp_recompute_bwd_reference). Its scratch is sized by
    RECOMPUTE_CHUNK points, not N. CUDA tensors launch the kernels (or
    raise), CPU tensors run the plain version. A field on the wide route
    runs wide_mlp.wide_recompute_backward."""
    global RECOMPUTE_BWD_LAUNCHES
    if config.grid_sizes:
        raise NotImplementedError(_NO_GRID_RECOMPUTE)
    if kernel_route(config, backward=True) == 'wide':
        return wide_mlp.wide_recompute_backward(config, params, points, dy)
    if points.device.type == 'cpu':
        return fused_mlp_recompute_bwd_reference(config, params, points, dy)
    grads = _recompute_backward_launch(config, params, points, dy)
    if points.shape[0]:
        RECOMPUTE_BWD_LAUNCHES += 1
    return grads


def _recompute_backward_launch(config: NeRFConfig, params: dict, points: torch.Tensor,
                               dy: torch.Tensor, defines: tuple = ()) -> dict:
    """Launches the recompute backward on CUDA tensors -> the gradients and
    'dpts'. `defines` launches a variant built with those macros
    (scripts/backward_ablation.py's measurement-only ablations)."""
    _check(config, params, points)
    dev = points.device
    n, H, L, O = points.shape[0], config.d_filter, config.n_layers, config.d_output
    _check_backward(config, dy, n, dev)
    w = _kernel_weights(config, params)
    e_pad = w.e_pad
    f32 = dict(dtype=torch.float32, device=dev)
    grad_chain = torch.empty(O * H + O + L * H, **f32)
    grad_dw = torch.empty(e_pad * H + (L - 1) * H * H, **f32)
    dpts = torch.empty((n, config.d_input), **f32)
    if n == 0:
        grad_chain.zero_()
        grad_dw.zero_()
        return dict(_grads_from_flat(config, grad_chain, grad_dw, grad_chain[:0], e_pad),
                    dpts=dpts)
    c = min(RECOMPUTE_CHUNK, -(-n // _TILE) * _TILE)
    pps, splits = dw_splits(config, c, e_pad, _sm_count(dev))
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    hs, cs = (torch.empty((c, L * H), **bf16) for _ in range(2))
    dz = torch.empty(dz_scratch_size(c, L, H), **bf16)
    out = torch.empty((c, O), **f32)
    enc = torch.empty((c, e_pad), **bf16)
    part_chain = torch.empty((c // _TILE, grad_chain.numel()), **f32)
    part_dw = torch.empty((splits, grad_dw.numel()), **f32)
    w_dpts, pairs, gdim = _dpts_weights(config, params['w_in'])
    _launch('fused_mlp_recompute_bwd', 23, 11, dev,
            points.data_ptr(), w.col_dim.data_ptr(), w.col_freq.data_ptr(),
            _wgmma_weights(params).data_ptr(), w.b_in.data_ptr(), w.b_h.data_ptr(),
            w.b_out.data_ptr(), dy.data_ptr(), _bwd_weights(params['w_h']).data_ptr(),
            w_dpts.data_ptr(), pairs.data_ptr(), gdim.data_ptr(), w.w_out.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), out.data_ptr(), dz.data_ptr(), enc.data_ptr(),
            part_chain.data_ptr(), part_dw.data_ptr(), grad_chain.data_ptr(),
            grad_dw.data_ptr(), dpts.data_ptr(),
            n, config.d_input, w.col_dim.numel(), e_pad, H, L - 1, O, pps, splits, c,
            8 * gdim.numel(), defines=defines)
    return dict(_grads_from_flat(config, grad_chain, grad_dw, grad_chain[:0], e_pad),
                dpts=dpts)


class FusedMLPStash(torch.autograd.Function):
    """raw = the field at `points`, differentiable in the parameters (the
    MLP's, then any grid tables: param_keys order) and, with compute_dpts,
    in the points: the forward is the stashing forward of `fmt` (K1, K6a or
    K6b: fused_mlp_stash_forward), which stashes each layer's sin and cos
    for the backward, the stashing backward (K2 / K6a / K6b, with K3 for
    the points: fused_mlp_stash_backward). Without compute_dpts the points
    get no gradient (None), as with the JAX kernel's compute_dpts=False."""

    @staticmethod
    def forward(ctx, config, points, fmt, compute_dpts, group, *weights):
        params = dict(zip(param_keys(config), weights))
        out, hs, cs = fused_mlp_stash_forward(config, params, points, fmt)
        ctx.config, ctx.fmt, ctx.compute_dpts, ctx.group = config, fmt, compute_dpts, group
        ctx.save_for_backward(points, hs, cs, *weights)
        return out

    @staticmethod
    def backward(ctx, dy):
        points, hs, cs, *weights = ctx.saved_tensors
        keys = param_keys(ctx.config)
        dpts = ctx.compute_dpts and ctx.needs_input_grad[1]
        grads = fused_mlp_stash_backward(ctx.config, dict(zip(keys, weights)), points,
                                         dy.contiguous(), hs, cs, ctx.fmt, dpts, ctx.group)
        return (None, grads.get('dpts'), None, None, None, *(grads[k] for k in keys))


class FusedMLPRecompute(torch.autograd.Function):
    """raw = the field at `points`, differentiable in the parameters and the
    points, with no activation memory: the forward is K0 (the no-grad
    render's kernel, so `out` is its bits), the backward K4
    (fused_mlp_recompute_backward), which recomputes the activations chunk
    by chunk. The JAX package's stash=False custom_vjp."""

    @staticmethod
    def forward(ctx, config, points, *weights):
        params = dict(zip(param_keys(config), weights))
        out = _forward_k0(config, params, points, backward=True)
        ctx.config = config
        ctx.save_for_backward(points, *weights)
        return out

    @staticmethod
    def backward(ctx, dy):
        points, *weights = ctx.saved_tensors
        keys = param_keys(ctx.config)
        grads = fused_mlp_recompute_backward(ctx.config, dict(zip(keys, weights)),
                                             points, dy.contiguous())
        dpts = grads['dpts'] if ctx.needs_input_grad[1] else None
        return (None, dpts, *(grads[k] for k in keys))


def fused_mlp_forward(config: NeRFConfig, params: dict, points: torch.Tensor,
                      stash=None, stash_bwd_tile: int = STASH_BWD_TILE,
                      compute_dpts: bool = True,
                      stash_format: str = 'int8') -> torch.Tensor:
    """raw [N, d_output] of the field at [N, d_input] points, base offsets
    excluded, with fused_nerf_raw's knobs. With no gradient needed: K0.
    When a parameter needs a gradient, or the points do and compute_dpts is
    on: stash=True or None (the stashing path, JAX's default on the chip)
    runs FusedMLPStash with `stash_format` ('int8' K1 + K2, 'lsb' K6a,
    'i8pair' K6b, whose dz scale groups are stash_bwd_tile points; the
    points' gradient is K3); stash=False runs FusedMLPRecompute (K0 + K4,
    no activation memory; it always gives the points their gradient).
    compute_dpts=False gives the points no gradient on the stashing path
    (the renderer detaches them). Grid configs take the 'int8' stash only
    and no point cotangent, and their recompute backward raises, as in the
    JAX package. kernel_route picks the kernels: the fused ones, or above
    512 units or outside their heads the wide route (ops/wide_mlp.py; its
    'i8pair' takes stash_bwd_tile a multiple of 32), for the forward and the
    backward alike. On the card a
    d_filter outside KERNEL_WIDTHS runs zero-padded to the next kernel width
    (pad_field), on the wide route to a multiple of 8."""
    if config.grid_rank:
        raise NotImplementedError(_NO_VM_KERNEL)
    _check_format(config, stash_format)
    stash = True if stash is None else bool(stash)
    keys = param_keys(config)
    wants_dpts = torch.is_grad_enabled() and points.requires_grad and (compute_dpts or not stash)
    grad = wants_dpts or (torch.is_grad_enabled()
                          and any(params[k].requires_grad for k in keys))
    if points.device.type == 'cuda':
        config, params = _route_field(config, params, kernel_route(config, grad))
    if grad:
        if wants_dpts and config.grid_sizes:
            raise NotImplementedError(_NO_GRID_DPTS)
        if stash:
            return FusedMLPStash.apply(config, points, stash_format, compute_dpts,
                                       stash_bwd_tile, *(params[k] for k in keys))
        if config.grid_sizes:
            raise NotImplementedError(_NO_GRID_RECOMPUTE)
        return FusedMLPRecompute.apply(config, points, *(params[k] for k in keys))
    return _forward_k0(config, params, points)


from sunerf_tpu_torch.ops import wide_mlp  # noqa: E402  (the wide route; registers its op)
