"""The 3-channel DT matrix on the port (scripts/dt_matrix.py of the
JAX package): seeds x equal-wall-clock configurations of the multi-thermal
MHD protocol (sunerf_tpu_torch/scripts/dt_protocol.py), each row a
subprocess with its own deadline, resumable (a row whose signature is
already in the output jsonl is skipped) and scene-cached.

The step counts are the JAX package's: they equalize wall-clock against the
4k-step parity row at the rates it measured on its chip (parity 47.3k,
tiered_half 167.2k, prop_24_48 ~145k rays/s); each row records the rate
measured here.

Usage: python -m sunerf_tpu_torch.scripts.dt_matrix [--out DT_MATRIX_r4_torch.jsonl]
       [--seeds 7 8 9] [--device cuda] [--deadline 14400]
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = [
    # (label, steps, extra args)
    ('dt_parity', 4000, []),
    ('dt_prop_24_48', 12000, ['--proposal-coarse', '--n-stratified', '24',
                              '--n-hierarchical', '48']),
    ('dt_tiered_half', 14000, ['--proposal-coarse', '--n-stratified', '32',
                               '--n-hierarchical', '64', '--tier-fraction',
                               '0.5', '--tier-samples', '16']),
    # tier warmup: the un-warmed tiered rows collapse to the zero-output
    # constant on this scene (the dim tier samples an untrained coarse CDF
    # and the multiplicative DT head starves); the first 1750 steps run
    # the full budget, then the tiers engage
    ('dt_tiered_warm', 14000, ['--proposal-coarse', '--n-stratified', '32',
                               '--n-hierarchical', '64', '--tier-fraction',
                               '0.5', '--tier-samples', '16',
                               '--tier-warmup-steps', '1750']),
]


def protocol_command(module: str, steps: int, seed: int, out: str, data_cache: str,
                     device: str, extra: list) -> list:
    """The subprocess's command: the port's protocol module under this
    interpreter, on `device`."""
    return [sys.executable, '-m', f'sunerf_tpu_torch.scripts.{module}',
            '--steps', str(steps), '--seed', str(seed), '--out', out,
            '--data-cache', data_cache, '--device', device] + list(extra)


def plan_row(module: str, label: str, steps: int, seed: int, out: str, data_cache: str,
             device: str, extra: list) -> tuple:
    """(label, seed, signature, command) of one row: the signature is the
    config the protocol records for the command's own arguments (its
    row_config), the key a finished row is found by."""
    cmd = protocol_command(module, steps, seed, out, data_cache, device, extra)
    protocol = importlib.import_module(f'sunerf_tpu_torch.scripts.{module}')
    return label, seed, protocol.row_config(protocol.build_parser().parse_args(cmd[3:])), cmd


def done_signatures(out: str) -> list:
    if not os.path.exists(out):
        return []
    with open(out) as fh:
        return [json.loads(line)['config'] for line in fh if line.strip()]


def run_rows(rows: list, out: str, deadline: float) -> list:
    """rows: (label, seed, signature, command). Runs each row whose
    signature is not yet in `out`, from the repository root, killed at
    `deadline` seconds; returns (label, seed, status) per row."""
    done = done_signatures(out)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get('PYTHONPATH')) if p))
    status = []
    for i, (label, seed, sig, cmd) in enumerate(rows, 1):
        tag = f'[{i}/{len(rows)}] {label} s{seed}'
        if sig in done:
            print(f'{tag}: already done, skip', flush=True)
            status.append((label, seed, 'skipped'))
            continue
        print(f'{tag}: running', flush=True)
        try:
            rc = subprocess.run(cmd, cwd=ROOT, env=env, timeout=deadline).returncode
        except subprocess.TimeoutExpired:
            print(f'{tag}: FAILED, past its {deadline:.0f} s deadline', flush=True)
            status.append((label, seed, 'deadline'))
            continue
        if rc != 0:
            print(f'{tag}: FAILED rc={rc}', flush=True)
        status.append((label, seed, 'ok' if rc == 0 else f'rc={rc}'))
    print(f'matrix done -> {out}', flush=True)
    return status


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default='DT_MATRIX_r4_torch.jsonl')
    parser.add_argument('--seeds', type=int, nargs='+', default=[7, 8, 9])
    parser.add_argument('--data-cache',
                        default=os.path.join(tempfile.gettempdir(), 'dt_scene_cache'))
    parser.add_argument('--device', default='cuda',
                        help="passed to each protocol run: 'cuda' (the card) or 'cpu'")
    parser.add_argument('--deadline', type=float, default=14400.0,
                        help='seconds each row may run before it is killed')
    args = parser.parse_args(argv)
    rows = [plan_row('dt_protocol', label, steps, seed, args.out, args.data_cache,
                     args.device, extra)
            for seed in args.seeds for label, steps, extra in CONFIGS]
    return run_rows(rows, args.out, args.deadline)


if __name__ == '__main__':
    main()
