"""Neural field models: the SuNeRF Sine MLP (sunerf_tpu/models/fields.py).

Parameters are plain tensors in the JAX package's layout — weights
[fan_in, fan_out], hidden layers stacked as w_h [L-1, H, H] and b_h [L-1, H]
— so a JAX deployment bundle loads with no transposes (params_from_numpy).
Architecture: 8 layers x 512 wide by default, Sine activation (w0=1),
positional encoding 4 -> 84 dims (10 log-spaced freqs), 2 outputs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from sunerf_tpu_torch.core.encoding import encoded_dim, positional_encoding
from sunerf_tpu_torch.ops import grid_encoding as ge

# AIA wavelength channels, index order used wherever a per-wavelength
# parameter or response table appears.
AIA_WAVELENGTHS = (94, 131, 171, 193, 211, 304, 335)

class FieldOutput(NamedTuple):
    """Uniform output contract for every field model.

    raw: [N, d_output] raw head inputs (emission/absorption or log-rho/log-T).
    log_abs: [7] per-wavelength log absorption (DT heads) or None.
    vol_c: scalar volumetric constant (DT heads) or None.
    """
    raw: torch.Tensor
    log_abs: Optional[torch.Tensor] = None
    vol_c: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Static configuration of the SuNeRF MLP — the same fields as the JAX
    package's NeRFConfig, so bundle specs round-trip unchanged."""
    d_input: int = 4
    d_output: int = 2
    n_layers: int = 8
    d_filter: int = 512
    n_freqs: int = 10
    scale_factor: float = 2.0
    # optional lower band count for the time axis (None = all bands)
    n_freqs_time: Optional[int] = None
    # density-temperature variant
    base_log_density: float = 0.0
    base_log_temperature: float = 0.0
    with_aux: bool = False  # learnable per-wavelength log_abs + volumetric constant
    # matmul precision of the JAX package's XLA path; the port's plain path
    # always runs in float32
    precision: str = 'default'
    # learned feature-grid encodings (ops/grid_encoding.py): per level a
    # dense [G, G, G, F] table, or with grid_rank > 0 VM factors (with
    # grid_time > 0, HexPlane time planes); their features follow the
    # positional encoding. () = off
    grid_sizes: tuple = ()
    grid_features: int = 8
    grid_bound: float = 2.0
    grid_rank: int = 0
    grid_time: int = 0
    grid_time_range: tuple = (0.0, 1.0)
    # a TPU layout flag of the JAX package's fused kernel: accepted, changes
    # nothing here
    grid_hat_mxu: bool = False

    def __post_init__(self):
        # specs round-trip through JSON, which turns tuples into lists;
        # coerce so the config stays hashable
        if not isinstance(self.grid_sizes, tuple):
            object.__setattr__(self, 'grid_sizes', tuple(self.grid_sizes))
        if not isinstance(self.grid_time_range, tuple):
            object.__setattr__(self, 'grid_time_range',
                               tuple(self.grid_time_range))
        if self.grid_time and not self.grid_rank:
            raise ValueError('grid_time requires grid_rank > 0 (temporal '
                             'levels are HexPlane-factorized; a dense 4-D '
                             'table is not implemented)')

    @property
    def d_grid(self) -> int:
        if self.grid_rank:
            return len(self.grid_sizes) * 3 * self.grid_rank
        return len(self.grid_sizes) * self.grid_features

    @property
    def d_encoded(self) -> int:
        return (encoded_dim(self.d_input, self.n_freqs, self.n_freqs_time)
                + self.d_grid)


def _base_offsets(config: NeRFConfig, raw: torch.Tensor) -> torch.Tensor:
    if config.base_log_density or config.base_log_temperature:
        raw = raw + torch.tensor(
            [config.base_log_density, config.base_log_temperature],
            dtype=raw.dtype, device=raw.device)
    return raw


def _field_output(config: NeRFConfig, params: dict, raw: torch.Tensor) -> FieldOutput:
    raw = _base_offsets(config, raw)
    if config.with_aux:
        return FieldOutput(raw=raw, log_abs=params['log_abs'], vol_c=params['vol_c'])
    return FieldOutput(raw=raw)


def _linear_init(generator: torch.Generator, fan_in: int, fan_out: int,
                 device, leading=()):
    bound = 1.0 / float(np.sqrt(fan_in))

    def uniform(shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u * (2.0 * bound) - bound).to(device)

    return uniform((*leading, fan_in, fan_out)), uniform((*leading, fan_out))


def init_nerf(generator: torch.Generator, config: NeRFConfig,
              device='cuda') -> dict:
    """Parameter dict with torch.nn.Linear's default init,
    U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for weights and biases; hidden layers
    stacked [L-1, H, H]; per grid level `grid_{i}` (dense), or
    `grid_planes_{i}` with `grid_lines_{i}` or `grid_tplanes_{i}` (VM)."""
    w_in, b_in = _linear_init(generator, config.d_encoded, config.d_filter, device)
    w_h, b_h = _linear_init(generator, config.d_filter, config.d_filter, device,
                            leading=(config.n_layers - 1,))
    w_out, b_out = _linear_init(generator, config.d_filter, config.d_output,
                                device)
    params = {'w_in': w_in, 'b_in': b_in, 'w_h': w_h, 'b_h': b_h,
              'w_out': w_out, 'b_out': b_out}
    if config.with_aux:
        params['log_abs'] = torch.full((len(AIA_WAVELENGTHS),), 1e-6,
                                       dtype=torch.float32, device=device)
        params['vol_c'] = torch.tensor(1.0, dtype=torch.float32, device=device)
    for i, g in enumerate(config.grid_sizes):
        if config.grid_rank and config.grid_time:
            params[f'grid_planes_{i}'], params[f'grid_tplanes_{i}'] = \
                ge.vm_time_init(generator, g, config.grid_time, config.grid_rank,
                                device=device)
        elif config.grid_rank:
            params[f'grid_planes_{i}'], params[f'grid_lines_{i}'] = \
                ge.vm_init(generator, g, config.grid_rank, device=device)
        else:
            params[f'grid_{i}'] = ge.grid_table_init(
                generator, g, config.grid_features, device=device)
    return params


def params_from_numpy(tree: dict, device='cuda') -> dict:
    """The JAX package's parameters (a nested dict of numpy arrays, as
    load_state returns them) -> the same nesting of float32 tensors on
    `device`. Layouts agree, so nothing is transposed."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32)).to(device)


def nerf_apply(config: NeRFConfig, params: dict, points: torch.Tensor) -> FieldOutput:
    """The plain float32 field at [N, d_input] query points: the positional
    encoding, then any grid levels' features, through the Sine MLP."""
    x = positional_encoding(points, config.n_freqs, config.scale_factor,
                            n_freqs_time=config.n_freqs_time)
    feats, bound = [x], config.grid_bound
    for i in range(len(config.grid_sizes)):
        if config.grid_rank and config.grid_time:
            feats.append(ge.vm_encode_time(params[f'grid_planes_{i}'],
                                           params[f'grid_tplanes_{i}'], points,
                                           bound=bound, t_range=config.grid_time_range))
        elif config.grid_rank:
            feats.append(ge.vm_encode(params[f'grid_planes_{i}'],
                                      params[f'grid_lines_{i}'], points, bound=bound))
        else:
            feats.append(ge.grid_encode(params[f'grid_{i}'], points, bound=bound))
    x = torch.cat(feats, dim=-1)
    h = torch.sin(x @ params['w_in'] + params['b_in'])
    for w, b in zip(params['w_h'], params['b_h']):
        h = torch.sin(h @ w + b)
    raw = h @ params['w_out'] + params['b_out']
    return _field_output(config, params, raw)


def nerf_apply_fused(config: NeRFConfig, params: dict, points: torch.Tensor,
                     compute_dpts: bool = True,
                     stash_format: str = 'int8') -> FieldOutput:
    """The same contract as nerf_apply, through the fused kernels
    (ops/fused_mlp.py): the hand-written CUDA kernels for CUDA tensors, their
    plain bf16-operand versions for CPU tensors. With no gradient needed it
    is the forward K0; when a parameter needs a gradient it is the stashing
    forward K1 with the stashing backward K2. compute_dpts=False gives the
    points no gradient (only valid for detached points, as the renderer's
    are); compute_dpts=True with points that need a gradient raises (K3 is
    not ported). Dense grid levels run in the kernels' grid branch (K5);
    only the 'int8' stash is ported. The kernels' raw output excludes the
    DT base offsets; they are added here."""
    from sunerf_tpu_torch.ops import fused_mlp
    raw = fused_mlp.fused_mlp_forward(config, params, points,
                                      compute_dpts=compute_dpts,
                                      stash_format=stash_format)
    return _field_output(config, params, raw)


def emission_config(**overrides) -> NeRFConfig:
    """Emission head field: (x,y,z,t) -> (log emission, absorption)."""
    return NeRFConfig(d_input=4, d_output=2, **overrides)


def density_temperature_config(**overrides) -> NeRFConfig:
    """DT head field: (x,y,z,t) -> (log density + 10, log10 T + 5) with learnable
    per-wavelength log absorption and volumetric constant."""
    defaults = dict(d_input=4, d_output=2, base_log_density=10.0,
                    base_log_temperature=5.0, with_aux=True)
    defaults.update(overrides)
    return NeRFConfig(**defaults)
