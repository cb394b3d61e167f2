"""Fused positional encoding + Sine MLP forward: the port of the TPU kernel
sunerf_tpu/ops/pallas/fused_mlp.py:_fwd_kernel.

`fused_mlp_forward` is the wrapper. For a CUDA tensor it launches the
hand-written kernel csrc/fused_mlp_fwd.cu (built by ops/build.py) or raises;
for a CPU tensor it runs `fused_mlp_reference`, the plain PyTorch version that
repeats the kernel's numerics: bf16 matmul operands, f32 accumulation, f32
bias and the kernels' range-reduced sine. Its raw output excludes the DT base
offsets (the caller adds them, as nerf_apply_fused does).

The kernel's weights are bf16 copies packed in mma.sync fragment order,
prepared once per parameter set and cached on the identity and version of
its tensors. No backward yet: a call that needs a gradient raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from sunerf_tpu_torch.core.encoding import encoding_columns
from sunerf_tpu_torch.models.fields import NeRFConfig

# kernel launches so far; a run sets it to 0 and reads it to show that its
# fields went through the kernel
LAUNCHES = 0

KERNEL_WIDTHS = (64, 128, 256, 384, 512)   # d_filter values the kernel takes
_KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
_prepared: WeakIdKeyDictionary = WeakIdKeyDictionary()
_TWO_PI = 6.283185307179586
_INV_TWO_PI = 0.15915494309189535
_HALF_PI = 1.5707963267948966


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def reduced_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) after the kernels' range reduction, x - 2*pi*round(x / 2*pi)
    with 2*pi rounded to f32. The reduction is what sets the kernels' sine
    apart from torch.sin (by up to ~4e-6 at the |z| ~ 70 pre-activations of
    the trained field, enough to flip bf16 roundings downstream); on the
    reduced argument the kernels' minimax polynomial is within 1e-7 of
    torch.sin."""
    return torch.sin(x - torch.round(x * _INV_TWO_PI).mul_(_TWO_PI))


def fused_mlp_reference(config: NeRFConfig, params: dict,
                        points: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function with the same
    roundings (bf16 matmul operands, f32 accumulation, f32 bias, and sines
    of arguments range-reduced as the kernels reduce them). The cos features
    are sin(u + pi/2) with u + pi/2 rounded to f32, as in the TPU kernel and
    the CUDA one."""
    dims, freqs = encoding_columns(config.d_input, config.n_freqs,
                                   config.scale_factor, config.n_freqs_time)
    u = points[:, dims] * torch.tensor(freqs, dtype=points.dtype,
                                       device=points.device)
    enc = torch.cat([points, reduced_sin(u), reduced_sin(u + _HALF_PI)], dim=-1)
    h = reduced_sin(_mm(enc, params['w_in']) + params['b_in'])
    for w, b in zip(params['w_h'], params['b_h']):
        h = reduced_sin(_mm(h, w) + b)
    return _mm(h, params['w_out']) + params['b_out']


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
    """One parameter set as the kernel reads it (device tensors)."""
    col_dim: torch.Tensor     # [n_cols] int32
    col_freq: torch.Tensor    # [n_cols] f32
    w_in: torch.Tensor        # packed fragments, rows padded to e_pad
    b_in: torch.Tensor        # [H] f32
    w_h: torch.Tensor         # [L-1, ...] packed fragments
    b_h: torch.Tensor         # [L-1, H] f32
    w_out: torch.Tensor       # [d_out, H] bf16
    b_out: torch.Tensor       # [d_out] f32
    e_pad: int


def _prepare(config: NeRFConfig, params: dict) -> _KernelWeights:
    device = params['w_in'].device
    dims, freqs = encoding_columns(config.d_input, config.n_freqs,
                                   config.scale_factor, config.n_freqs_time)
    e_pad = -(-config.d_encoded // 16) * 16
    f32 = dict(dtype=torch.float32, device=device)
    w_in = F.pad(params['w_in'].float(), (0, 0, 0, e_pad - config.d_encoded))
    return _KernelWeights(
        col_dim=torch.tensor(dims, dtype=torch.int32, device=device),
        col_freq=torch.tensor(freqs, **f32),
        w_in=pack_fragments(w_in),
        b_in=params['b_in'].float().contiguous(),
        w_h=pack_fragments(params['w_h'].float()),
        b_h=params['b_h'].float().contiguous(),
        w_out=params['w_out'].t().to(torch.bfloat16).contiguous(),
        b_out=params['b_out'].float().contiguous(),
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
    if config.grid_sizes:
        raise NotImplementedError('the fused kernel has no feature-grid '
                                  'branch yet (ROADMAP Queue 2 K5)')
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


def _entry():
    from sunerf_tpu_torch.ops import build
    fn = build.load('fused_mlp_fwd').sunerf_fused_mlp_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_mlp_forward(config: NeRFConfig, params: dict,
                      points: torch.Tensor) -> torch.Tensor:
    """raw [N, d_output] of the field at [N, d_input] points, base offsets
    excluded. CUDA tensors: the kernel (or an error); CPU tensors: the plain
    version."""
    global LAUNCHES
    if torch.is_grad_enabled() and (points.requires_grad or any(
            params[k].requires_grad for k in _KEYS)):
        raise NotImplementedError('the fused kernel has no backward yet '
                                  '(ROADMAP Queue 2 K1 + K2); use nerf_apply '
                                  'where gradients are needed')
    if points.device.type == 'cpu':
        return fused_mlp_reference(config, params, points)
    if points.device.type != 'cuda':
        raise ValueError(f'no fused kernel for device {points.device}')
    _check(config, params, points)
    n = points.shape[0]
    out = torch.empty((n, config.d_output), dtype=torch.float32,
                      device=points.device)
    if n == 0:
        return out
    w = _kernel_weights(config, params)
    with torch.cuda.device(points.device):
        err = _entry()(
            points.data_ptr(), w.col_dim.data_ptr(), w.col_freq.data_ptr(),
            w.w_in.data_ptr(), w.b_in.data_ptr(), w.w_h.data_ptr(),
            w.b_h.data_ptr(), w.w_out.data_ptr(), w.b_out.data_ptr(),
            out.data_ptr(), n, config.d_input, w.col_dim.numel(), w.e_pad,
            config.d_filter, config.n_layers - 1, config.d_output,
            torch.cuda.current_stream(points.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'fused_mlp_fwd kernel launch failed: CUDA error {err}')
    LAUNCHES += 1
    return out
