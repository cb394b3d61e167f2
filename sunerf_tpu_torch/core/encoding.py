"""Positional encoding for 4D (x, y, z, t) query points
(sunerf_tpu/core/encoding.py:13-61).

gamma(x) = [x, sin(x * 2^k / s), cos(x * 2^k / s)] for k = 0..n_freqs-1,
frequency-major, so weights are interchangeable with the JAX package and the
reference ordering.
"""
from __future__ import annotations

import torch


def _column_mask(d_input: int, n_freqs: int, n_freqs_time) -> 'list[bool]':
    """Frequency-major (k, d) column inclusion. With n_freqs_time set (and a
    4-D x,y,z,t input), the t dimension only gets the lowest n_freqs_time
    bands."""
    mask = []
    for k in range(n_freqs):
        for d in range(d_input):
            is_time = (d == d_input - 1) and n_freqs_time is not None
            mask.append(k < n_freqs_time if is_time else True)
    return mask


def encoded_dim(d_input: int, n_freqs: int, n_freqs_time=None) -> int:
    return d_input + 2 * sum(_column_mask(d_input, n_freqs, n_freqs_time))


def encoding_columns(d_input: int, n_freqs: int, scale_factor: float,
                     n_freqs_time=None) -> 'tuple[list[int], list[float]]':
    """(input dim, frequency) of every sin/cos column, in layout order: column
    j's phase is x[:, dims[j]] * freqs[j] (log-spaced bands)."""
    mask = _column_mask(d_input, n_freqs, n_freqs_time)
    dims, freqs = [], []
    for k in range(n_freqs):
        for d in range(d_input):
            if mask[k * d_input + d]:
                dims.append(d)
                freqs.append(2.0 ** k / scale_factor)
    return dims, freqs


def positional_encoding(x: torch.Tensor, n_freqs: int = 10,
                        scale_factor: float = 2.0,
                        n_freqs_time=None) -> torch.Tensor:
    """[..., D] -> [..., encoded_dim]: [x, sin(phases), cos(phases)] with the
    phases frequency-major (time columns beyond n_freqs_time omitted)."""
    dims, freqs = encoding_columns(x.shape[-1], n_freqs, scale_factor,
                                   n_freqs_time)
    u = x[..., dims] * torch.tensor(freqs, dtype=x.dtype, device=x.device)
    return torch.cat([x, torch.sin(u), torch.cos(u)], dim=-1)


def init_trainable_encoding(d_input: int, n_freqs: int = 20, device='cpu') -> dict:
    """Learnable frequency bands (sunerf_tpu/core/encoding.py:64-70;
    reference TrainablePositionalEncoding, model.py:75-89): log2
    frequencies linspace(-3, 9) for every input dimension, [F, D]."""
    freqs = torch.linspace(-3.0, 9.0, n_freqs, dtype=torch.float32, device=device)
    return {'frequencies': freqs[:, None].expand(n_freqs, d_input).contiguous()}


def trainable_encoding_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """[N, D] -> [N, 2*F*D]: sin and cos of pi * 2^f * x, each divided by its
    frequency, frequency-major within each half (model.py:83-89)."""
    freqs = torch.pi * 2.0 ** params['frequencies']     # [F, D]
    encoded = x[:, None, :] * freqs[None]               # [N, F, D]
    n = x.shape[0]
    return torch.cat([(torch.sin(encoded) / freqs[None]).reshape(n, -1),
                      (torch.cos(encoded) / freqs[None]).reshape(n, -1)], dim=-1)
