"""Score a saved emission bundle against the psi_193 protocol ground truth
on the port (scripts/score_bundle.py of the JAX package).

Offline cash-in of checkpoints that outlived their training run (VERDICT
r4 #2a: the salvaged s8 probe re-run best bundle,
artifacts_r4/s8_probe_rerun_best.npz) — the protocol scene is
deterministic, so the exact 18-view ground truth a bundle was trained
against can be resynthesized at any time (scripts/psi_protocol.py
ensure_scene) and scored through the same metrics harness
(|lat| > 7 deg train/test split, reference protocol:
sunerf/evaluation/stash/metrics_simulation.py:40-76). The bundle renders
through SuNeRFLoader on `--device` (K0 on the card).

Usage: python -m sunerf_tpu_torch.scripts.score_bundle \
           --bundle artifacts_r4/s8_probe_rerun_best.npz --resolution 256 \
           --data-cache <dir> --label s8_probe_rerun_150k [--device cuda] [--out FILE]
Prints one JSON line (main returns it).
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--bundle', required=True)
    parser.add_argument('--resolution', type=int, default=256)
    parser.add_argument('--data-cache', required=True)
    parser.add_argument('--label', required=True,
                        help='row label recording the bundle provenance')
    parser.add_argument('--out', default=None)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)

    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.evaluation.metrics_harness import evaluate_viewpoints
    from sunerf_tpu_torch.scripts.psi_protocol import ensure_scene

    _, gt_dir = ensure_scene(args.data_cache, args.resolution, device=args.device)
    loader = SuNeRFLoader(args.bundle, device=args.device)
    metrics = evaluate_viewpoints(loader,
                                  sorted(glob.glob(os.path.join(gt_dir,
                                                                '*.fits'))))
    out = {'label': args.label, 'bundle': args.bundle,
           'resolution': args.resolution,
           'train': metrics['train'], 'test': metrics['test']}
    print(json.dumps(out))
    if args.out:
        with open(args.out, 'a') as fh:
            fh.write(json.dumps(out) + '\n')
    return out


if __name__ == '__main__':
    main()
