"""Training objective: coarse+fine image MSE plus out-of-domain
regularization (sunerf_tpu/train/objective.py):

  loss = lambda_image * (MSE(coarse, target) + MSE(fine, target))
       + lambda_regularization * mean(regularization)

with asinh image scaling on both prediction and target for the emission head
and raw intensities for the DT head.
"""
from __future__ import annotations

import dataclasses

import torch

from sunerf_tpu_torch.core.scaling import image_asinh_scaling


@dataclasses.dataclass(frozen=True)
class LossConfig:
    lambda_image: float = 1.0
    lambda_regularization: float = 1.0
    image_scaling: str = 'asinh'   # 'asinh' (emission) | 'none' (DT)
    scaling_vmax: float = 1.0
    scaling_a: float = 0.005
    # total-variation penalty on feature-grid tables (grid_* params,
    # ops/grid_encoding.py table_tv), the few-view smoothness prior of grid
    # encodings; 0.0 = off
    lambda_table_tv: float = 0.0


def scale_image(config: LossConfig, image: torch.Tensor) -> torch.Tensor:
    if config.image_scaling == 'asinh':
        return image_asinh_scaling(image, vmax=config.scaling_vmax, a=config.scaling_a)
    if config.image_scaling == 'none':
        return image
    raise ValueError(f'Unknown image scaling {config.image_scaling}')


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def render_loss(config: LossConfig, outputs: dict,
                target_image: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The training loss and scalar metrics from renderer outputs."""
    target = scale_image(config, target_image)
    coarse = scale_image(config, outputs['coarse_image'])
    fine = scale_image(config, outputs['fine_image'])

    coarse_loss = mse(coarse, target)
    fine_loss = mse(fine, target)
    regularization_loss = torch.mean(outputs['regularization'])

    loss = (config.lambda_image * (coarse_loss + fine_loss)
            + config.lambda_regularization * regularization_loss)
    psnr = -10.0 * torch.log10(fine_loss)

    metrics = {'loss': loss, 'coarse_loss': coarse_loss, 'fine_loss': fine_loss,
               'regularization_loss': regularization_loss, 'psnr': psnr}
    return loss, metrics
