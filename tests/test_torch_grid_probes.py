"""The port's grid-encode probes P1 and P2 (sunerf_tpu_torch/ops/grid_probes.py
and the ported scripts/probe_grid_taps.py, probe_grid_hatbuild.py) against
the JAX package's probe kernels in interpret mode on the CPU, and against
torch.nn.functional.grid_sample. Inputs come from numpy seeds; torch runs at
one thread. The JAX scripts are loaded from their files, unchanged.

Tolerances, each with its reason:
  * P1 within 1e-5 abs of the JAX kernel (the JAX script's own check): the
    same float32 operations in the same order, which XLA may contract into
    fused multiply-adds;
  * P2, each variant, within 1% of max|ref| + 1e-4 with RMS within 1e-4 of
    max (tests/test_fused_mlp.py:33's forward tolerance): the same bf16
    weights and table, float32 sums of four nonzero products in another
    order;
  * against grid_sample: P1 within 1e-5 (grid_sample computes the same
    coordinates as ((p / bound + 1) / 2) (G - 1), rounded otherwise); P2's
    'iota' within 1e-2 of max, for the kernel's bf16 hat weights.
The kernels themselves are held to these plain versions on the card, in
tests/test_torch_kernel.py (marked gpu) and chip_smoke.py.
"""
import ctypes
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.functional import grid_sample

from sunerf_tpu_torch.ops import build, grid_probes
from sunerf_tpu_torch.scripts import probe_grid_hatbuild, probe_grid_taps

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f'jax_{name}',
                                                  REPO / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tap_points(G: int, bound: float, seed: int) -> np.ndarray:
    """128 points: 80 U(-1.3 b, 1.3 b), some outside the box; 32 on grid
    nodes (0.5 (G - 1) / b = 2 makes them exact); and +-b and beyond."""
    rng = np.random.default_rng(seed)
    rand = rng.uniform(-1.3 * bound, 1.3 * bound, (80, 3))
    nodes = -bound + rng.integers(0, G, (32, 3)) / 2.0
    edges = np.array([[bound, bound, bound], [-bound, -bound, -bound],
                      [bound, -bound, 0.0], [-bound, 0.0, bound],
                      [0.0, bound, -bound], [2 * bound, -2 * bound, bound],
                      [-bound, 3 * bound, -3 * bound], [bound, 0.25, -bound]] * 2)
    return np.concatenate([rand, nodes, edges]).astype(np.float32)


@pytest.mark.parametrize('G,F', [(8, 8), (4, 16)])
def test_tap_encode_matches_jax_kernel(G, F):
    jax_taps = _jax_script('probe_grid_taps')
    bound = 0.25 * (G - 1)          # scale 0.5 (G - 1) / bound = 2: nodes exact
    rng = np.random.default_rng(G)
    table4 = rng.standard_normal((G, G, G, F)).astype(np.float32)
    pts = _tap_points(G, bound, G + 1)
    want = np.asarray(jax_taps.make_tap_encode(G, F, bound, 64, interpret=True)(
        jax_taps.pack_table(jnp.asarray(table4)), jnp.asarray(pts)))
    before = grid_probes.TAP_LAUNCHES
    got = grid_probes.tap_encode(grid_probes.pack_table(torch.from_numpy(table4)),
                                 torch.from_numpy(pts), G, bound)
    assert grid_probes.TAP_LAUNCHES == before
    assert got.shape == (len(pts), F)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _hat_inputs(G: int, F: int, n: int = 128, seed: int = 5):
    rng = np.random.default_rng(seed)
    table = np.array(jnp.asarray(rng.standard_normal((G * G, G * F)),
                                   jnp.bfloat16).astype(jnp.float32))
    pts = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    pts[:4, 1:] = [[1.3, 1.3], [-1.3, -1.3], [1.3, -1.3], [0.0, 1.3]]
    return table, pts


@pytest.mark.parametrize('variant', grid_probes.HAT_VARIANTS)
def test_hat_encode_matches_jax_kernel(variant):
    jax_hat = _jax_script('probe_grid_hatbuild')
    G, F, bound = 8, 8, 1.3
    table, pts = _hat_inputs(G, F)
    e1, e2 = grid_probes.expansion_matrices(G)
    jax_ops = (jnp.asarray(e1, jnp.bfloat16), jnp.asarray(e2, jnp.bfloat16))
    want = np.asarray(jax_hat.make_encode(G, F, bound, 64, variant, True)(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(pts),
        *(jax_ops if variant == 'expand' else ())))
    torch_ops = tuple(torch.from_numpy(e).bfloat16() for e in (e1, e2))
    before = grid_probes.HAT_LAUNCHES
    got = grid_probes.hat_encode(torch.from_numpy(table).bfloat16(), torch.from_numpy(pts),
                                 G, bound, variant,
                                 *(torch_ops if variant == 'expand' else ())).numpy()
    assert grid_probes.HAT_LAUNCHES == before
    assert got.shape == (len(pts), G * F)
    m = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-2 * m + 1e-4
    assert np.sqrt(np.mean((got - want) ** 2)) <= 1e-4 * m


def test_tap_encode_matches_grid_sample():
    G, F, bound = 8, 8, 1.3
    rng = np.random.default_rng(11)
    table4 = torch.from_numpy(rng.standard_normal((G, G, G, F)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(-1.6, 1.6, (300, 3)).astype(np.float32))
    got = grid_probes.tap_encode(grid_probes.pack_table(table4), pts, G, bound)
    # input [1, F, D = y, H = z, W = x]; grid (x, y, z) indexes (W, H, D)
    grid = (pts[:, [0, 2, 1]] / bound).reshape(1, -1, 1, 1, 3)
    lib = grid_sample(table4.permute(3, 0, 1, 2)[None], grid, mode='bilinear',
                        padding_mode='border', align_corners=True)
    np.testing.assert_allclose(got.numpy(), lib.reshape(F, -1).T.numpy(), rtol=0,
                               atol=1e-5)


def test_hat_encode_matches_grid_sample():
    G, F, bound = 8, 8, 1.3
    table, pts = _hat_inputs(G, F, n=300, seed=12)
    table, pts = torch.from_numpy(table), torch.from_numpy(pts)
    got = grid_probes.hat_encode(table.bfloat16(), pts, G, bound, 'iota')
    # input [1, G F, H = y, W = z]; grid (z, y) indexes (W, H)
    lib = grid_sample(table.T.reshape(1, G * F, G, G),
                        (pts[:, [2, 1]] / bound).reshape(1, -1, 1, 2), mode='bilinear',
                        padding_mode='border', align_corners=True)
    lib = lib.reshape(G * F, -1).T
    assert (got - lib).abs().max() <= 1e-2 * lib.abs().max()


@pytest.mark.parametrize('script,argv', [
    ('taps', ['--n', '64', '--grid', '4', '8', '--reps', '1']),
    ('taps', ['--check']),
    ('hatbuild', ['--n', '64', '--grid', '8', '--reps', '1']),
    ('hatbuild', ['--check']),
])
def test_probe_scripts_run_on_the_cpu(script, argv):
    mod = {'taps': probe_grid_taps, 'hatbuild': probe_grid_hatbuild}[script]
    counts = grid_probes.TAP_LAUNCHES, grid_probes.HAT_LAUNCHES
    out = mod.main(argv + ['--device', 'cpu'])
    assert (grid_probes.TAP_LAUNCHES, grid_probes.HAT_LAUNCHES) == counts
    assert out['device'] == 'cpu'
    if '--check' in argv:
        assert out['check'] == 'ok'
        return
    keys = ([f'taps_{g}^3_{k}' for g in (4, 8) for k in ('ms', 'ns_per_tap')]
            if script == 'taps' else [f'{v}_ms' for v in grid_probes.HAT_VARIANTS])
    assert all(np.isfinite(out[k]) and out[k] > 0 for k in keys)
    assert out['n_points'] == 64


@pytest.mark.parametrize('mod', [probe_grid_taps, probe_grid_hatbuild])
def test_probe_scripts_without_a_card_exit(mod):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the scripts run on it')
    with pytest.raises(SystemExit) as exc:
        mod.main(['--n', '64'])
    assert exc.value.code not in (0, None)


def test_hat_variant_and_launch_signature():
    with pytest.raises(ValueError):
        grid_probes.hat_encode(torch.zeros(64, 64).bfloat16(), torch.zeros(4, 3), 8, 1.3,
                               'onehot')
    with pytest.raises(ValueError):
        probe_grid_hatbuild.make_encode(8, 8, 1.3, 64, 'onehot')
    assert build.signature(2, 1, 2) == (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_float)
