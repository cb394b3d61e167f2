"""The matrix layer on the port (sunerf_tpu_torch/scripts/summarize_matrix.py,
dt_matrix.py, dt_matrix_r5.py, psi_matrix.py) against the JAX package's
scripts on the CPU:

  * summarize_matrix: stdout, plain and --markdown, identical to JAX's on
    the committed DT_MATRIX_r4.jsonl, DT_MATRIX_r5.jsonl and
    PSI_MATRIX_r3.jsonl;
  * the matrix scripts: for every CONFIGS entry x seed, the planned row's
    signature (the port protocol's row_config of the subprocess's parsed
    arguments) equal to JAX's run_signature, the CONFIGS tables equal, and the
    subprocess command `python -m sunerf_tpu_torch.scripts.<protocol>` with
    --device passed through;
  * run_rows: a row whose signature is in the output file is skipped, a
    row past its deadline is killed and reported, a failing row reported by
    its exit code.
"""
import json
import sys
from pathlib import Path

import pytest

from sunerf_tpu_torch.scripts import (dt_matrix, dt_matrix_r5, dt_protocol, psi_matrix,
                                      psi_protocol, summarize_matrix)

REPO = Path(__file__).resolve().parents[1]
SEEDS = (7, 8, 9)


def _jax_script(name):
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        sys.modules.pop(name, None)
        return __import__(name)
    finally:
        sys.path.remove(str(REPO / 'scripts'))


@pytest.mark.parametrize('path', ['DT_MATRIX_r4.jsonl', 'DT_MATRIX_r5.jsonl',
                                  'PSI_MATRIX_r3.jsonl'])
@pytest.mark.parametrize('markdown', [False, True])
def test_summarize_matrix_matches_jax(path, markdown, monkeypatch, capsys):
    flags = [str(REPO / path)] + (['--markdown'] if markdown else [])
    jax_summarize = _jax_script('summarize_matrix')
    monkeypatch.setattr(sys, 'argv', ['summarize_matrix.py', *flags])
    jax_summarize.main()
    want = capsys.readouterr().out
    rows = summarize_matrix.main(flags)
    assert capsys.readouterr().out == want
    assert len(rows) == len(want.strip().splitlines()) - (2 if markdown else 0)


def _protocol_args(cmd, module, parser):
    assert cmd[0] == sys.executable and cmd[1:3] == ['-m', f'sunerf_tpu_torch.scripts.{module}']
    i = cmd.index('--device')
    assert cmd[i + 1] == 'cpu'
    return parser.parse_args(cmd[3:])


@pytest.mark.parametrize('port,name', [(dt_matrix, 'dt_matrix'), (dt_matrix_r5, 'dt_matrix_r5')])
def test_dt_matrix_scripts_match_jax(port, name, tmp_path, monkeypatch):
    """The port matrix's planned rows (run_rows recorded, not run): each
    signature equal to JAX's run_signature and to the port protocol's
    config of the row's command."""
    jax_matrix = _jax_script(name)
    assert port.CONFIGS == jax_matrix.CONFIGS
    common = getattr(port, 'COMMON', [])
    assert common == getattr(jax_matrix, 'COMMON', [])
    planned = []
    monkeypatch.setattr(port, 'run_rows', lambda rows, out, deadline: planned.extend(rows))
    port.main(['--seeds', *map(str, SEEDS), '--device', 'cpu', '--out',
               str(tmp_path / 'm.jsonl')])
    assert len(planned) == len(port.CONFIGS) * len(SEEDS)
    parser = dt_protocol.build_parser()
    configs = {c[0]: c for c in port.CONFIGS}
    for label, seed, sig, cmd in planned:
        _, steps, extra = configs[label]
        assert sig == jax_matrix.run_signature(steps, extra, seed), (label, seed)
        assert dt_protocol.row_config(_protocol_args(cmd, 'dt_protocol', parser)) == sig, label


@pytest.mark.parametrize('keep_best', [False, True])
@pytest.mark.parametrize('resolution', [128, 256])
def test_psi_matrix_matches_jax(keep_best, resolution, tmp_path, monkeypatch):
    """The port matrix's planned rows (run_rows recorded, not run) against
    JAX's run_signature, and the port protocol's config of each command."""
    jax_matrix = _jax_script('psi_matrix')
    assert psi_matrix.CONFIGS == jax_matrix.CONFIGS
    planned = []
    monkeypatch.setattr(psi_matrix, 'run_rows', lambda rows, out, deadline: planned.extend(rows))
    psi_matrix.main(['--seeds', *map(str, SEEDS), '--device', 'cpu', '--resolution',
                     str(resolution), '--out', str(tmp_path / 'm.jsonl')]
                    + (['--keep-best'] if keep_best else []))
    assert len(planned) == len(psi_matrix.CONFIGS) * len(SEEDS)
    parser = psi_protocol.build_parser()
    configs = {c[0]: c for c in psi_matrix.CONFIGS}
    for label, seed, sig, cmd in planned:
        _, steps, extra = configs[label]
        extra = list(extra) + (['--keep-best'] if keep_best else [])
        want = jax_matrix.run_signature(steps, extra, seed)
        if resolution != 128:
            want['resolution'] = resolution
        assert sig == want, label
        assert psi_protocol.row_config(_protocol_args(cmd, 'psi_protocol', parser)) == sig, label


def test_psi_matrix_refuses_unknown_labels():
    with pytest.raises(SystemExit):
        psi_matrix.main(['--only', 'parity', 'no_such_row', '--device', 'cpu'])


def test_run_rows_skips_kills_and_reports(tmp_path):
    out = tmp_path / 'rows.jsonl'
    done = {'steps': 1, 'seed': 7}
    out.write_text(json.dumps({'config': done}) + '\n')
    py = sys.executable
    status = dt_matrix.run_rows([
        ('done', 7, done, [py, '-c', 'raise SystemExit(3)']),
        ('slow', 8, {'steps': 2}, [py, '-c', 'import time; time.sleep(30)']),
        ('fails', 9, {'steps': 3}, [py, '-c', 'raise SystemExit(3)']),
        ('ok', 9, {'steps': 4}, [py, '-c', 'import sunerf_tpu_torch'])], str(out), deadline=3.0)
    assert status == [('done', 7, 'skipped'), ('slow', 8, 'deadline'), ('fails', 9, 'rc=3'),
                      ('ok', 9, 'ok')]


def test_dt_matrix_r5_only_plans_the_parity_rows(tmp_path, monkeypatch):
    planned = []
    monkeypatch.setattr(dt_matrix_r5, 'run_rows', lambda rows, out, deadline: planned.extend(rows))
    dt_matrix_r5.main(['--only', 'dt_parity', '--seeds', '7', '8', '9', '--device', 'cpu',
                       '--out', str(tmp_path / 'm.jsonl')])
    assert [(label, seed) for label, seed, _, _ in planned] == [('dt_parity', s) for s in SEEDS]
    for _, seed, sig, cmd in planned:
        assert sig['steps'] == 8000 and sig['resolution'] == 256 and sig['seed'] == seed
        assert cmd[cmd.index('--out') + 1] == str(tmp_path / 'm.jsonl')
