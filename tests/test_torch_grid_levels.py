"""K5, the dense feature-grid branch of the fused kernels, at any number of
levels (sunerf_tpu_torch/ops/fused_mlp.py), on the CPU: the kernels' plain
versions against the JAX package's fused grid kernels in interpret mode at
5 levels, and the layouts the card's kernels read (the per-level
descriptors, the scatter's work items, the grid cotangent's wgmma pack, the
scatter's merge of a warp's equal rows). Inputs come from numpy seeds;
torch runs at one thread.

Tolerances, each with its reason (tests/test_torch_grid.py's):
  * the plain forward within 1% of max|ref| + 1e-4 of JAX's kernel and of
    the float32 field: bf16 matmul operands on both sides;
  * every gradient, the five tables' included, within 3% of its max: bf16
    dz flips compound down the chain (the TPU kernel also rounds its hat
    weights to bf16, the port does not);
  * the layouts exactly: they are index arithmetic.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.models.fields import NeRFConfig as JaxNeRFConfig
from sunerf_tpu.models.fields import nerf_apply as jax_nerf_apply
from sunerf_tpu.models.fields import nerf_apply_fused as jax_nerf_apply_fused
from sunerf_tpu.ops.pallas.fused_mlp import (_dims_from_config, _fused_mlp_stash_bwd,
                                             _fused_mlp_stash_fwd)
from sunerf_tpu_torch.models.fields import NeRFConfig, nerf_apply_fused, params_from_numpy
from sunerf_tpu_torch.ops import fused_mlp
from sunerf_tpu_torch.ops import grid_encoding as ge

torch.set_num_threads(1)

# tests/test_torch_grid.py's GRID_TINY with five levels
FIVE = dict(n_layers=3, d_filter=64, n_freqs=4, grid_sizes=(4, 5, 6, 7, 8), grid_features=8)
KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
TABLES = tuple(f'grid_{i}' for i in range(5))
CSRC = Path(__file__).resolve().parents[1] / 'sunerf_tpu_torch' / 'csrc'


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


def _params(config, seed=0) -> dict:
    """numpy params: torch.nn.Linear-style layers and U(-1, 1) tables (the
    1e-4 init times 1e4, so the tables carry signal)."""
    rng = np.random.default_rng(seed)

    def lin(fan_in, fan_out, *lead):
        b = 1.0 / np.sqrt(fan_in)
        return (rng.uniform(-b, b, (*lead, fan_in, fan_out)).astype(np.float32),
                rng.uniform(-b, b, (*lead, fan_out)).astype(np.float32))
    w_in, b_in = lin(config.d_encoded, config.d_filter)
    w_h, b_h = lin(config.d_filter, config.d_filter, config.n_layers - 1)
    w_out, b_out = lin(config.d_filter, config.d_output)
    p = dict(w_in=w_in, b_in=b_in, w_h=w_h, b_h=b_h, w_out=w_out, b_out=b_out)
    for i, g in enumerate(config.grid_sizes):
        p[f'grid_{i}'] = rng.uniform(-1, 1, (g, g, g, config.grid_features)).astype(np.float32)
    return p


def _points(n, seed=1, lim=1.5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-lim, lim, (n, 4)).astype(np.float32)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


def _configs():
    return JaxNeRFConfig(**FIVE), NeRFConfig(**FIVE)


# ------------------------------------------------- the plain versions vs JAX

def test_plain_forward_matches_jax_kernel_at_five_levels():
    """K0's and K1's plain versions with five grid levels against the JAX
    fused field in interpret mode (its K0) and the float32 field of both
    packages: 1% of max + 1e-4; each level's features enter the encoding in
    level order after sin/cos, with grid_encode's bits."""
    jc, tc = _configs()
    params, pts = _params(tc, seed=21), _points(50, seed=22)
    jp = jax.tree.map(jnp.asarray, params)
    tp, tpts = params_from_numpy(params, 'cpu'), torch.from_numpy(pts)
    ref_k = np.asarray(jax_nerf_apply_fused(jc, jp, jnp.asarray(pts), tile=16,
                                            bwd_tile=16, interpret=True).raw)
    ref_f32 = np.asarray(jax.jit(jax_nerf_apply, static_argnums=0)(
        jc, jp, jnp.asarray(pts)).raw)
    k0 = fused_mlp.fused_mlp_reference(tc, tp, tpts).numpy()
    k1, _, _ = fused_mlp.fused_mlp_stash_reference(tc, tp, tpts)
    np.testing.assert_array_equal(k1.numpy(), k0)
    for ref in (ref_k, ref_f32):
        assert np.max(np.abs(ref - k0)) < 0.01 * np.max(np.abs(ref)) + 1e-4
    enc = fused_mlp._encode(tc, tp, tpts)
    off = fused_mlp._grid_offset(tc)
    assert enc.shape == (50, tc.d_encoded) and tc.d_grid == 40
    for i, g in enumerate(tc.grid_sizes):
        np.testing.assert_array_equal(
            enc[:, off + 8 * i:off + 8 * (i + 1)].numpy(),
            ge.grid_encode(tp[f'grid_{i}'], tpts, tc.grid_bound).numpy())


def test_plain_backward_matches_jax_kernel_at_five_levels():
    """K2's plain version fed the JAX K1's own stash against JAX's K2 (grid
    branch, interpret mode) at five levels: every gradient, the five tables'
    included, within 3% of its max."""
    jc, tc = _configs()
    params, pts = _params(tc, seed=23), _points(48, seed=24)
    dy = np.random.default_rng(25).normal(size=(48, 2)).astype(np.float32)
    dims = _dims_from_config(jc)
    fwd = jax.jit(functools.partial(_fused_mlp_stash_fwd, dims, 16, 16, True, False, 'int8'))
    bwd = jax.jit(functools.partial(_fused_mlp_stash_bwd, dims, 16, 16, True, False, 'int8'))
    _, residuals = fwd(jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    dparams, _ = bwd(residuals, jnp.asarray(dy))
    _, _, hs, cs = residuals
    got = fused_mlp.fused_mlp_stash_bwd_reference(
        tc, params_from_numpy(params, 'cpu'), torch.from_numpy(pts), torch.from_numpy(dy),
        torch.from_numpy(np.asarray(hs[:48], np.float32)).to(torch.bfloat16),
        torch.from_numpy(np.array(cs[:48])))
    for k in KEYS + TABLES:
        assert got[k].shape == params[k].shape, k
        assert _rel(dparams[k], got[k].numpy()) < 3e-2, k


def test_fused_grads_match_jax_at_five_levels():
    """nerf_apply_fused on CPU tensors that need a gradient (FusedMLPStash
    on the plain K1 / K2) against jax.grad of the JAX grid kernels in
    interpret mode at five levels (loss mean(raw^2)): every gradient within
    3% of its max."""
    jc, tc = _configs()
    params, pts = _params(tc, seed=26), _points(48, seed=27)
    jp = jax.tree.map(jnp.asarray, params)
    ref = jax.jit(jax.grad(lambda p: jnp.mean(jax_nerf_apply_fused(
        jc, p, jnp.asarray(pts), stash=True, stash_tile=16, stash_bwd_tile=16,
        interpret=True, compute_dpts=False).raw ** 2)))(jp)
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(params, 'cpu').items()}
    (nerf_apply_fused(tc, tp, torch.from_numpy(pts), compute_dpts=False).raw ** 2
     ).mean().backward()
    for k in KEYS + TABLES:
        assert _rel(ref[k], tp[k].grad.numpy()) < 3e-2, k


def test_the_level_limit_is_gone():
    """No level limit in the wrapper or the kernels' sources; G >= 2 stays
    the only rule on the levels (checked where the kernels launch)."""
    assert not hasattr(fused_mlp, 'MAX_GRID_LEVELS')
    for src in CSRC.glob('*.cu*'):
        assert 'kMaxLevels' not in src.read_text(), src.name


# ------------------------------------------------- the layouts on the card

@pytest.mark.parametrize('grid_sizes,features', [((16,), 8), ((16, 32), 8),
                                                 ((4, 5, 6, 7, 8), 8), ((3, 9, 2), 3)])
def test_grid_descriptors_cover_d_table(grid_sizes, features):
    """The per-level descriptors (table address, offset, G) in grid_keys
    order: each level's offset is where _grads_from_flat reads its d_table,
    and the levels' [offset, offset + G^3 F) ranges tile [0, total) once,
    with no gap and no overlap."""
    cfg = NeRFConfig(n_layers=2, d_filter=64, n_freqs=2, grid_sizes=grid_sizes,
                     grid_features=features)
    params = params_from_numpy(_params(cfg, seed=3), 'cpu')
    desc = fused_mlp.grid_descriptors(cfg, params).numpy()
    offsets = fused_mlp.grid_offsets(cfg)
    total = sum(g ** 3 * features for g in grid_sizes)
    assert desc.shape == (len(grid_sizes), 3) and offsets[-1] == total
    covered = np.zeros(total, np.int64)
    for i, (k, g) in enumerate(zip(fused_mlp.grid_keys(cfg), grid_sizes)):
        ptr, off, size = desc[i]
        assert ptr == params[k].data_ptr() and size == g and off == offsets[i]
        covered[off:off + g ** 3 * features] += 1
    assert (covered == 1).all()
    # d_table's views are taken at the same offsets
    flat = torch.arange(total, dtype=torch.float32)
    e_pad = -(-cfg.d_encoded // 16) * 16
    grads = fused_mlp._grads_from_flat(
        cfg, torch.zeros(cfg.d_output * 64 + cfg.d_output + 2 * 64),
        torch.zeros(e_pad * 64 + 64 * 64), flat, e_pad)
    for i, (k, g) in enumerate(zip(fused_mlp.grid_keys(cfg), grid_sizes)):
        assert grads[k].shape == (g, g, g, features)
        assert int(grads[k].reshape(-1)[0]) == offsets[i]
    args = fused_mlp._grid_args(cfg, params)
    assert (args.n_levels, args.features, args.total) == (len(grid_sizes), features, total)
    assert args.levels == fused_mlp.grid_descriptors(cfg, params).data_ptr()   # kept
    assert args.vec4 == int(features % 4 == 0)


@pytest.mark.parametrize('n,levels', [(1, 1), (31, 5), (4097, 2), (1000, 3)])
def test_grid_scatter_items_cover_every_point_level_once(n, levels):
    """grid_scatter_kernel's quad t // 4 takes (point (t // 4) % n, level
    (t // 4) // n), lane t % 4 its features t % 4 + 4 k: over its 4 n
    levels threads every (point, level) once, every feature of it once
    (F = 8 and 6), and a warp's quads are consecutive points of one level
    except where it crosses a level's end."""
    t = np.arange(4 * n * levels)
    pt, level, part = fused_mlp.grid_scatter_item(t, n)
    assert fused_mlp.GRID_SCATTER_LANES == 4
    for F in (8, 6):
        seen = np.zeros((n, levels, F), np.int64)
        for f0 in range(0, F, 4):
            live = part + f0 < F
            np.add.at(seen, (pt[live], level[live], (part + f0)[live]), 1)
        assert (seen == 1).all()
    for w in range(0, 4 * n * levels, 32):
        lanes = slice(w, min(w + 32, 4 * n * levels))
        assert (pt[lanes][::4] == pt[lanes][::4][0]
                + np.arange(len(pt[lanes][::4]))).all() or (np.diff(level[lanes]) != 0).any()
        assert (pt[lanes].reshape(-1, 4) == pt[lanes][::4, None]).all()


@pytest.mark.parametrize('d_filter,grid_sizes,features', [
    (64, (8,), 8), (128, (16,), 8), (512, (16, 32), 8), (128, (4, 5, 6, 7, 8), 8),
    (64, (4, 5), 3)])
def test_grid_pack_unpacks_to_w_in_rows(d_filter, grid_sizes, features):
    """pack_wgmma_grid read back as the chain kernel's grid cotangent reads
    it: stage cc, k-chunk kc = k // 32, the [32 x 32] chunk's element (k,
    n) at ((k % 32 // 8) * 4 + n // 8) * 64 + (n % 8) * 8 + k % 8 (wgmma's
    K-major B, warpgroup w's 16 columns from n-group 2 w): bf16(W_in[grid
    row 32 cc + n, k]), zeros past the grid rows."""
    cfg = NeRFConfig(n_layers=2, d_filter=d_filter, n_freqs=2, grid_sizes=grid_sizes,
                     grid_features=features)
    w_in = torch.from_numpy(_params(cfg, seed=4)['w_in'])
    off = fused_mlp._grid_offset(cfg)
    rows = w_in[off:off + cfg.d_grid]
    pack = fused_mlp.pack_wgmma_grid(rows)
    n_gc = -(-cfg.d_grid // fused_mlp.GRID_STAGE_COLS)
    assert pack.dtype == torch.bfloat16 and pack.shape == (n_gc * d_filter // 32, 32 * 32)
    flat = pack.reshape(-1).float()
    k = torch.arange(d_filter).view(-1, 1)
    for cc in range(n_gc):
        n = torch.arange(32).view(1, -1)
        idx = (cc * (d_filter // 32) * 1024 + (k // 32) * 1024
               + ((k % 32 // 8) * 4 + n // 8) * 64 + (n % 8) * 8 + k % 8)
        col = 32 * cc + n.view(-1)
        want = torch.zeros(d_filter, 32)
        live = col < cfg.d_grid
        want[:, live] = rows[col[live]].t().to(torch.bfloat16).float()
        assert torch.equal(flat[idx], want), cc


def _warp_run_sums(keys: np.ndarray, vals: np.ndarray, merge: bool = True) -> dict:
    """grid_scatter_kernel's reds of one corner and feature group over a
    warp, in numpy: keys [32] (the table row of lane 4 p + q's point p, -1
    none; the same for a quad), vals [32] int64 terms (lane q's feature) ->
    {(row, lane q): the sum the reds add}. With merge (unless every point
    starts a run) the points' runs of equal keys are summed by the kernel's
    segmented suffix sum (shuffles down by 4, 8, 16 lanes, each taken where
    it stays inside the lane's run of its class), and the run's first point
    adds the sum; else each lane adds its own term."""
    lane = np.arange(32)
    q_of = lane % 4
    prev = np.full(32, -2)
    prev[4:] = keys[:-4]
    head = (lane < 4) | (prev != keys)
    merge = merge and not head.all()
    end = np.empty(32, int)
    for i in lane:
        later = [j for j in range(i + 4, 32, 4) if head[j]]
        end[i] = later[0] - 4 if later else 28 + q_of[i]
    q = vals.copy()
    if merge:
        for off in (4, 8, 16):
            o = np.zeros(32, np.int64)
            o[:32 - off] = q[off:]
            q = np.where(lane + off <= end, q + o, q)
    out = {}
    for i in lane:
        if (merge and not head[i]) or q[i] == 0 or keys[i] < 0:
            continue
        k = (int(keys[i]), int(q_of[i]))
        out[k] = out.get(k, 0) + int(q[i])
    return out


@pytest.mark.parametrize('seed', range(6))
def test_scatter_merge_gives_the_terms_sums(seed):
    """The scatter's merge of a warp's runs of equal table rows adds, per
    element, exactly the sum of the lanes' terms (runs of every length,
    repeats of a row in separate runs, points past the end keyed -1), as
    the per-term reds do: the fixed-point sums and d_table keep their
    bits."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 5, 8)
    rows = np.repeat(rng.integers(0, 3, 8), runs)[:8]
    rows[8 - seed // 2:] = -1
    keys = np.repeat(rows, 4)
    vals = rng.integers(-2 ** 40, 2 ** 40, 32)
    vals[keys < 0] = 0
    want = {}
    for i, (kk, v) in enumerate(zip(keys, vals)):
        if kk >= 0 and v != 0:
            want[(int(kk), i % 4)] = want.get((int(kk), i % 4), 0) + int(v)
    for merge in (True, False):
        got = _warp_run_sums(keys, vals, merge)
        assert {k: v for k, v in got.items() if v} == {k: v for k, v in want.items() if v}
