"""Fused positional encoding + Sine MLP: the ports of the TPU kernels of
sunerf_tpu/ops/pallas/fused_mlp.py that the emission paths run.

  K0 _fwd_kernel        -> csrc/fused_mlp_fwd.cu        forward, no gradient
  K1 _fwd_stash_kernel  -> csrc/fused_mlp_stash_fwd.cu  training forward,
                           sin stash bf16 + cos stash int8
  K2 _bwd_stash_kernel  -> csrc/fused_mlp_stash_bwd.cu  training backward
                           (fmt 'int8', no point cotangent)
  K5 the dense feature-grid branch of all three (_encode_grid, d_table):
     trilinear features of each level's [G, G, G, F] table after the
     sin/cos columns (grid_feature in csrc/fused_mlp_common.cuh), and in
     K2 the tables' gradients, summed in fixed point so a run gives the
     same bits as the last

`fused_mlp_forward` is the entry. With no gradient needed it runs K0; when a
parameter needs one it runs `FusedMLPStash`, the autograd Function whose
forward is K1 and whose backward is K2, as the JAX package's custom_vjp
`_fused_mlp_stash` is. A point cotangent (K3) is not ported: the renderer
detaches its sample points (compute_dpts=False). VM grid levels
(grid_rank > 0) have no kernel, as in the JAX package.

Each kernel's wrapper launches it for CUDA tensors, checks the CUDA error
code the launch returns and raises on any failure; for CPU tensors it runs
the kernel's plain PyTorch version (`fused_mlp_reference`,
`fused_mlp_stash_reference`, `fused_mlp_stash_bwd_reference`), which
repeats its numerics: bf16 matmul operands, f32 accumulation, f32 bias and
the kernels' range-reduced sine. Raw outputs exclude the DT base offsets
(nerf_apply_fused adds them).

The kernels read bf16 copies of the weights packed in mma.sync fragment
order (W_h transposed as well, for K2), prepared once per parameter set and
cached on the identity and version of its tensors: a training step packs
once per field, and the optimizer's in-place update invalidates the pack.
The grid tables are not cached: the kernels read the float32 parameters
themselves, so an in-place update is seen by the next launch.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from sunerf_tpu_torch.core.encoding import encoded_dim, encoding_columns
from sunerf_tpu_torch.models.fields import NeRFConfig
from sunerf_tpu_torch.ops.grid_encoding import grid_encode, grid_encode_table_grad

# kernel launches so far, one per wrapper call that launched: a run sets them
# to 0 and reads them to show that its fields went through the kernels
LAUNCHES = 0               # K0, fused_mlp_fwd
STASH_FWD_LAUNCHES = 0     # K1, fused_mlp_stash_fwd
STASH_BWD_LAUNCHES = 0     # K2, fused_mlp_stash_bwd
GRID_LAUNCHES = 0          # K5: launches of K0, K1 or K2 with grid levels

KERNEL_WIDTHS = (64, 128, 256, 384, 512)   # d_filter values the kernels take
MAX_BWD_OUTPUTS = 4                         # d_output values K2 takes: 1..4
MAX_GRID_LEVELS = 4                         # grid levels the kernels take
_KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
_NO_VM_KERNEL = ('VM grid levels (grid_rank > 0) have no fused kernel; they run '
                 'the float32 field (use_fused=False), as in the JAX package')
_prepared: WeakIdKeyDictionary = WeakIdKeyDictionary()
_TWO_PI = 6.283185307179586
_INV_TWO_PI = 0.15915494309189535
_HALF_PI = 1.5707963267948966
# degree-8 even cos polynomial of the TPU kernel (_COS8_C, max abs err 4.1e-5)
_COS8_C = (9.999598405e-01, -4.997933042e-01, 4.149612510e-02,
           -1.339285342e-03, 1.879295230e-05)
_COS_SCALE = 127.0
# bf16(1 / 127), the dequantization factor of the int8 cos stash
_INV_COS_SCALE_BF16 = 0.00787353515625
_DW_TILE = 128          # K2's dW output tile (csrc/fused_mlp_stash_bwd.cu)


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
    u = points[:, dims] * torch.tensor(freqs, dtype=points.dtype,
                                       device=points.device)
    grid = [grid_encode(params[k], points, config.grid_bound)
            for k in grid_keys(config)]
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
    """Each Sine layer's (bf16 sin, int8 cos8) of one range-reduced
    pre-activation. Layer i+1's input is layer i's bf16 sin, or, given
    `inputs` (a sin stash), that stash's block i."""
    H = config.d_filter
    h = _encode(config, params, points)
    hs, cs = [], []
    for i, (w, b) in enumerate(_layers(params)):
        y = _reduce(_mm(h, w) + b)
        hs.append(torch.sin(y).to(torch.bfloat16))
        cs.append(cos8_quantized(y))
        h = hs[-1] if inputs is None else inputs[:, i * H:(i + 1) * H]
    return hs, cs


def fused_mlp_stash_reference(config: NeRFConfig, params: dict,
                              points: torch.Tensor):
    """Plain PyTorch version of K1 -> (out [N, d_out] f32, hs [N, L*H] bf16,
    cs [N, L*H] int8). out is K0's (bit for bit fused_mlp_reference's);
    layer i's block of hs is the bf16 sine that feeds layer i+1, and of cs
    the int8 cos8 of the same reduced argument."""
    hs, cs = _stash_layers(config, params, points)
    out = _mm(hs[-1], params['w_out']) + params['b_out']
    return out, torch.cat(hs, 1), torch.cat(cs, 1)


def fused_mlp_stash_layerwise(config: NeRFConfig, params: dict,
                              points: torch.Tensor, hs: torch.Tensor):
    """(hs, cs) of the plain version with each layer's input taken from the
    given sin stash (layer 0's from the encoding): the stash that a kernel
    should write given its own upstream activations. Holding a kernel's
    stash to it isolates each layer's roundings from the bf16 flips
    upstream, which compound over the layers."""
    out_hs, out_cs = _stash_layers(config, params, points, inputs=hs)
    return torch.cat(out_hs, 1), torch.cat(out_cs, 1)


def fused_mlp_stash_bwd_reference(config: NeRFConfig, params: dict,
                                  points: torch.Tensor, dy: torch.Tensor,
                                  hs: torch.Tensor, cs: torch.Tensor) -> dict:
    """Plain PyTorch version of K2 -> parameter gradients in the JAX layout
    (w_in [E, H], b_in [H], w_h [L-1, H, H], b_h [L-1, H], w_out [H, O],
    b_out [O], grid_i [G, G, G, F]), f32. The TPU kernel's roundings: dy
    enters both its products as bf16; the dequantized cos is
    bf16(bf16(cs) * bf16(1/127)); dz is the bf16 product of bf16(dh) and
    that; products take bf16 operands and accumulate in f32; bias gradients
    sum dz (and dy) in f32; the encoding is recomputed from the points. A
    grid level's cotangent is dz_0 bf16(w_in[its rows])^T, spread over its
    table by grid_encode_table_grad (float32 index_add)."""
    H, L = config.d_filter, config.n_layers

    def sin_(i):
        return hs[:, i * H:(i + 1) * H].float()

    def cos_(i):
        return _bf(cs[:, i * H:(i + 1) * H].float() * _INV_COS_SCALE_BF16)

    dyb = _bf(dy)
    grads = {'w_out': sin_(L - 1).t() @ dyb, 'b_out': dy.sum(0)}
    dh = dyb @ _bf(params['w_out']).t()
    dw_h, db_h = [None] * (L - 1), [None] * (L - 1)
    for i in range(L - 2, -1, -1):
        dz = _bf(_bf(dh) * cos_(i + 1))
        dw_h[i] = sin_(i).t() @ dz
        db_h[i] = dz.sum(0)
        dh = dz @ _bf(params['w_h'][i]).t()
    dz = _bf(_bf(dh) * cos_(0))
    grads['w_in'] = _bf(_encode(config, params, points)).t() @ dz
    grads['b_in'] = dz.sum(0)
    empty = torch.zeros((0, H), dtype=torch.float32, device=points.device)
    grads['w_h'] = torch.stack(dw_h) if dw_h else empty.reshape(0, H, H)
    grads['b_h'] = torch.stack(db_h) if db_h else empty
    if config.grid_sizes:
        F_ = config.grid_features
        off = _grid_offset(config)
        denc = dz @ _bf(params['w_in'][off:off + config.d_grid]).t()
        for i, (k, g) in enumerate(zip(grid_keys(config), config.grid_sizes)):
            grads[k] = grid_encode_table_grad(points, denc[:, i * F_:(i + 1) * F_],
                                              g, config.grid_bound)
    return grads


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """[..., K, N] float weights -> bf16 [..., N/8, K/16, 32, 4] in the B
    fragment order of mma.sync m16n8k16: for lane l = 4g + t of n-tile nt and
    k-step ks, the 4 values are W[16ks + {2t, 2t+1, 2t+8, 2t+9}, 8nt + g], so
    one warp's fragment load is 256 contiguous bytes."""
    *lead, k, n = w.shape
    nl = len(lead)
    wb = w.to(torch.bfloat16).reshape(*lead, k // 16, 2, 4, 2, n // 8, 8)
    # (ks, k-half, t, k-pair, nt, g) -> (nt, ks, g, t, k-half, k-pair)
    perm = [*range(nl), nl + 4, nl, nl + 5, nl + 2, nl + 1, nl + 3]
    return wb.permute(perm).contiguous().reshape(*lead, n // 8, k // 16, 32, 4)


@dataclasses.dataclass(frozen=True, eq=False)
class _KernelWeights:
    """One parameter set as the kernels read it (device tensors)."""
    col_dim: torch.Tensor     # [n_cols] int32
    col_freq: torch.Tensor    # [n_cols] f32
    w_in: torch.Tensor        # packed fragments, rows padded to e_pad
    b_in: torch.Tensor        # [H] f32
    w_h: torch.Tensor         # [L-1, ...] packed fragments
    w_h_t: torch.Tensor       # [L-1, ...] packed fragments of w_h^T (K2)
    b_h: torch.Tensor         # [L-1, H] f32
    w_out: torch.Tensor       # [d_out, H] bf16
    b_out: torch.Tensor       # [d_out] f32
    w_grid: torch.Tensor      # [levels * F, H] bf16 grid rows of w_in (K2)
    e_pad: int


def _prepare(config: NeRFConfig, params: dict) -> _KernelWeights:
    device = params['w_in'].device
    dims, freqs = encoding_columns(config.d_input, config.n_freqs,
                                   config.scale_factor, config.n_freqs_time)
    e_pad = -(-config.d_encoded // 16) * 16
    f32 = dict(dtype=torch.float32, device=device)
    off = _grid_offset(config)
    with torch.no_grad():
        w_in = F.pad(params['w_in'].float(), (0, 0, 0, e_pad - config.d_encoded))
        w_h = params['w_h'].float()
        return _KernelWeights(
            col_dim=torch.tensor(dims, dtype=torch.int32, device=device),
            col_freq=torch.tensor(freqs, **f32),
            w_in=pack_fragments(w_in),
            b_in=params['b_in'].float().contiguous(),
            w_h=pack_fragments(w_h),
            w_h_t=pack_fragments(w_h.transpose(-1, -2)),
            b_h=params['b_h'].float().contiguous(),
            w_out=params['w_out'].t().to(torch.bfloat16).contiguous(),
            b_out=params['b_out'].float().contiguous(),
            w_grid=params['w_in'][off:off + config.d_grid].to(torch.bfloat16).contiguous(),
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


def _check(config: NeRFConfig, params: dict, points: torch.Tensor):
    if points.device.type != 'cuda':
        raise ValueError(f'no fused kernel for device {points.device}')
    if config.grid_rank:
        raise NotImplementedError(_NO_VM_KERNEL)
    if len(config.grid_sizes) > MAX_GRID_LEVELS or min(config.grid_sizes,
                                                       default=2) < 2:
        raise ValueError(f'the fused kernels take up to {MAX_GRID_LEVELS} grid '
                         f'levels of 2 or more cells a side, got '
                         f'{config.grid_sizes}')
    if config.d_filter not in KERNEL_WIDTHS:
        raise ValueError(f'fused kernel takes d_filter in {KERNEL_WIDTHS}, '
                         f'got {config.d_filter}')
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
        _check_tensor(f'params[{k!r}]', params[k], (g, g, g, config.grid_features),
                      torch.float32, points.device)


def _check_tensor(name: str, t: torch.Tensor, shape, dtype, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f'{name} must be {dtype} {list(shape)} on {device}, got '
                         f'{t.dtype} {list(t.shape)} on {t.device}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


class _GridArgs(ctypes.Structure):
    """GridParams of csrc/fused_mlp_common.cuh, passed by pointer."""
    _fields_ = [('table', ctypes.c_void_p * MAX_GRID_LEVELS),
                ('size', ctypes.c_int * MAX_GRID_LEVELS),
                ('n_levels', ctypes.c_int),
                ('features', ctypes.c_int),
                ('bound', ctypes.c_float)]


def _grid_args(config: NeRFConfig, params: dict) -> _GridArgs:
    """The live float32 tables (checked by _check) as the kernels take
    them; the caller keeps `params` alive over the launch."""
    args = _GridArgs()
    for i, (k, g) in enumerate(zip(grid_keys(config), config.grid_sizes)):
        args.table[i] = params[k].data_ptr()
        args.size[i] = g
    args.n_levels = len(config.grid_sizes)
    args.features = config.grid_features
    args.bound = config.grid_bound
    return args


def _kernel(name: str, n_ptrs: int, n_ints: int):
    """The C entry sunerf_<name> of csrc/<name>.cu, built on first use."""
    from sunerf_tpu_torch.ops import build
    fn = getattr(build.load(name), f'sunerf_{name}')
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, n_ptrs: int, n_ints: int, device, *args):
    with torch.cuda.device(device):
        err = _kernel(name, n_ptrs, n_ints)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')


def _fwd_args(w: _KernelWeights, points, grid: _GridArgs, out):
    return (points.data_ptr(), w.col_dim.data_ptr(), w.col_freq.data_ptr(),
            w.w_in.data_ptr(), w.b_in.data_ptr(), w.w_h.data_ptr(),
            w.b_h.data_ptr(), w.w_out.data_ptr(), w.b_out.data_ptr(),
            ctypes.addressof(grid), out.data_ptr())


def _fwd_ints(config, w: _KernelWeights, n: int):
    return (n, config.d_input, w.col_dim.numel(), w.e_pad, config.d_filter,
            config.n_layers - 1, config.d_output)


def _count_grid(config: NeRFConfig):
    global GRID_LAUNCHES
    if config.grid_sizes:
        GRID_LAUNCHES += 1


def _forward_k0(config: NeRFConfig, params: dict,
                points: torch.Tensor) -> torch.Tensor:
    """The K0 wrapper: CUDA tensors launch the kernel (or raise), CPU
    tensors run its plain version."""
    global LAUNCHES
    if points.device.type == 'cpu':
        return fused_mlp_reference(config, params, points)
    _check(config, params, points)
    n = points.shape[0]
    out = torch.empty((n, config.d_output), dtype=torch.float32,
                      device=points.device)
    if n == 0:
        return out
    w = _kernel_weights(config, params)
    grid = _grid_args(config, params)
    _launch('fused_mlp_fwd', 11, 7, points.device,
            *_fwd_args(w, points, grid, out), *_fwd_ints(config, w, n))
    LAUNCHES += 1
    _count_grid(config)
    return out


def fused_mlp_stash_forward(config: NeRFConfig, params: dict,
                            points: torch.Tensor):
    """The K1 wrapper -> (out [N, d_out] f32, hs [N, L*H] bf16, cs [N, L*H]
    int8). CUDA tensors launch the kernel (or raise), CPU tensors run its
    plain version."""
    global STASH_FWD_LAUNCHES
    if points.device.type == 'cpu':
        return fused_mlp_stash_reference(config, params, points)
    _check(config, params, points)
    n, lh = points.shape[0], config.n_layers * config.d_filter
    dev = points.device
    out = torch.empty((n, config.d_output), dtype=torch.float32, device=dev)
    hs = torch.empty((n, lh), dtype=torch.bfloat16, device=dev)
    cs = torch.empty((n, lh), dtype=torch.int8, device=dev)
    if n == 0:
        return out, hs, cs
    w = _kernel_weights(config, params)
    grid = _grid_args(config, params)
    _launch('fused_mlp_stash_fwd', 13, 7, dev, *_fwd_args(w, points, grid, out),
            hs.data_ptr(), cs.data_ptr(), *_fwd_ints(config, w, n))
    STASH_FWD_LAUNCHES += 1
    _count_grid(config)
    return out, hs, cs


def _dw_splits(config: NeRFConfig, n: int, e_pad: int, sm_count: int) -> int:
    """How many point ranges K2's dW products are split into (each with its
    own f32 partials, summed in a fixed order): enough blocks for about four
    per SM, and at least 1024 points per range."""
    tiles = (-(-max(config.d_filter, e_pad) // _DW_TILE)
             * -(-config.d_filter // _DW_TILE) * config.n_layers)
    return max(1, min(-(-4 * sm_count // tiles), -(-n // 1024)))


def _grads_from_flat(config: NeRFConfig, grad_chain: torch.Tensor,
                     grad_dw: torch.Tensor, grad_grid: torch.Tensor,
                     e_pad: int) -> dict:
    """K2's f32 output buffers -> gradients in the JAX layout (views)."""
    H, L, O = config.d_filter, config.n_layers, config.d_output
    db = grad_chain[O * H + O:].view(L, H)
    grads = {'w_in': grad_dw[:e_pad * H].view(e_pad, H)[:config.d_encoded],
             'b_in': db[0],
             'w_h': grad_dw[e_pad * H:].view(L - 1, H, H),
             'b_h': db[1:],
             'w_out': grad_chain[:O * H].view(H, O),
             'b_out': grad_chain[O * H:O * H + O]}
    off, F_ = 0, config.grid_features
    for k, g in zip(grid_keys(config), config.grid_sizes):
        grads[k] = grad_grid[off:off + g ** 3 * F_].view(g, g, g, F_)
        off += g ** 3 * F_
    return grads


def fused_mlp_stash_backward(config: NeRFConfig, params: dict,
                             points: torch.Tensor, dy: torch.Tensor,
                             hs: torch.Tensor, cs: torch.Tensor) -> dict:
    """The K2 wrapper -> parameter gradients in the JAX layout (see
    fused_mlp_stash_bwd_reference). CUDA tensors launch the kernel (or
    raise), CPU tensors run its plain version."""
    global STASH_BWD_LAUNCHES
    if points.device.type == 'cpu':
        return fused_mlp_stash_bwd_reference(config, params, points, dy, hs, cs)
    _check(config, params, points)
    if not 1 <= config.d_output <= MAX_BWD_OUTPUTS:
        raise ValueError(f'the stashing backward takes d_output in 1..'
                         f'{MAX_BWD_OUTPUTS}, got {config.d_output}')
    dev = points.device
    n, H, L, O = points.shape[0], config.d_filter, config.n_layers, config.d_output
    _check_tensor('dy', dy, (n, O), torch.float32, dev)
    _check_tensor('hs', hs, (n, L * H), torch.bfloat16, dev)
    _check_tensor('cs', cs, (n, L * H), torch.int8, dev)
    w = _kernel_weights(config, params)
    e_pad = w.e_pad
    f32 = dict(dtype=torch.float32, device=dev)
    grad_chain = torch.empty(O * H + O + L * H, **f32)
    grad_dw = torch.empty(e_pad * H + (L - 1) * H * H, **f32)
    n_table = sum(g ** 3 for g in config.grid_sizes) * config.grid_features
    grad_grid = torch.empty(n_table, **f32)
    if n == 0:
        for t in (grad_chain, grad_dw, grad_grid):
            t.zero_()
        return _grads_from_flat(config, grad_chain, grad_dw, grad_grid, e_pad)
    splits = _dw_splits(config, n, e_pad,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    dz = torch.empty((n, L * H), dtype=torch.bfloat16, device=dev)
    enc = torch.empty((n, e_pad), dtype=torch.bfloat16, device=dev)
    part_chain = torch.empty((-(-n // 64), grad_chain.numel()), **f32)
    part_dw = torch.empty((splits, grad_dw.numel()), **f32)
    grid = _grid_args(config, params)
    # K5 scratch: the grid cotangent, each level's max |.| (as float bits)
    # and the fixed-point sums, the last two zeroed
    dgrid = torch.empty((n, config.d_grid), **f32)
    gmax = torch.zeros(len(config.grid_sizes), dtype=torch.int32, device=dev)
    gacc = torch.zeros(n_table, dtype=torch.int64, device=dev)
    _launch('fused_mlp_stash_bwd', 20, 8, dev,
            points.data_ptr(), w.col_dim.data_ptr(), w.col_freq.data_ptr(),
            dy.data_ptr(), hs.data_ptr(), cs.data_ptr(), w.w_h_t.data_ptr(),
            w.w_out.data_ptr(), dz.data_ptr(), enc.data_ptr(),
            part_chain.data_ptr(), part_dw.data_ptr(), grad_chain.data_ptr(),
            grad_dw.data_ptr(), ctypes.addressof(grid), w.w_grid.data_ptr(),
            dgrid.data_ptr(), gmax.data_ptr(), gacc.data_ptr(), grad_grid.data_ptr(),
            n, config.d_input, w.col_dim.numel(), e_pad, H, L - 1, O, splits)
    STASH_BWD_LAUNCHES += 1
    _count_grid(config)
    return _grads_from_flat(config, grad_chain, grad_dw, grad_grid, e_pad)


class FusedMLPStash(torch.autograd.Function):
    """raw = the field at `points`, differentiable in the parameters (the
    MLP's, then any grid tables: param_keys order): the forward is K1
    (fused_mlp_stash_forward), which stashes each layer's sin and cos for
    the backward, K2 (fused_mlp_stash_backward). The points get no gradient
    (None), as with the JAX kernel's compute_dpts=False."""

    @staticmethod
    def forward(ctx, config, points, *weights):
        params = dict(zip(param_keys(config), weights))
        out, hs, cs = fused_mlp_stash_forward(config, params, points)
        ctx.config = config
        ctx.save_for_backward(points, hs, cs, *weights)
        return out

    @staticmethod
    def backward(ctx, dy):
        points, hs, cs, *weights = ctx.saved_tensors
        keys = param_keys(ctx.config)
        grads = fused_mlp_stash_backward(ctx.config, dict(zip(keys, weights)),
                                         points, dy.contiguous(), hs, cs)
        return (None, None, *(grads[k] for k in keys))


def fused_mlp_forward(config: NeRFConfig, params: dict, points: torch.Tensor,
                      compute_dpts: bool = True,
                      stash_format: str = 'int8') -> torch.Tensor:
    """raw [N, d_output] of the field at [N, d_input] points, base offsets
    excluded. With no gradient needed: K0. When a parameter needs a gradient:
    FusedMLPStash (K1 forward, K2 backward). compute_dpts=True with points
    that need a gradient raises: that cotangent is K3, not ported (and, for
    grid configs, not defined in the JAX kernels either); compute_dpts=False
    gives the points no gradient (the renderer detaches them). stash_format
    'int8' is the only stash ported ('lsb' and 'i8pair' are K6a/K6b; grid
    configs take 'int8' only, as in the JAX package)."""
    if config.grid_rank:
        raise NotImplementedError(_NO_VM_KERNEL)
    if stash_format != 'int8':
        if config.grid_sizes:
            raise NotImplementedError(f'grid-encoding configs support the int8 '
                                      f'stash only, got {stash_format!r}')
        raise NotImplementedError(f'stash_format {stash_format!r} is not ported '
                                  f'(K6a/K6b, ROADMAP Queue 2)')
    keys = param_keys(config)
    if torch.is_grad_enabled():
        if compute_dpts and points.requires_grad:
            if config.grid_sizes:
                raise NotImplementedError(
                    'grid-encoding configs skip point cotangents (the renderer '
                    'detaches sample points); pass compute_dpts=False or use '
                    'nerf_apply')
            raise NotImplementedError(
                'the fused kernels have no point cotangent yet (K3, the '
                'compute_dpts=True branch of the stashing backward: ROADMAP '
                'Queue 2); pass compute_dpts=False with detached points, or '
                'use nerf_apply')
        if any(params[k].requires_grad for k in keys):
            return FusedMLPStash.apply(config, points, *(params[k] for k in keys))
    return _forward_k0(config, params, points)
