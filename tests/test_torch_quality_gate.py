"""The port's colors quality gate (viewformer_tpu_torch/tools/quality_gate.py)
against the JAX package's (tools/quality_gate_colors.py): --regate and
--combine on the reports of tests/test_quality_gate_tool.py give the same
exit codes, `gate` dicts and derived thresholds; --quick --device cpu runs
every stage of the port's CLI end to end with jax, flax, viewformer_tpu and
the repo's tools/ blocked, each stage appending its kernel launches
(VIEWFORMER_LAUNCH_COUNTS); without --device the tool refuses to start on a
host without CUDA."""
import json
import math
import os
import subprocess
import sys

import pytest

from test_quality_gate_tool import _report, _seed_report
from viewformer_tpu_torch.tools import quality_gate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = [sys.executable, os.path.join(ROOT, 'tools', 'quality_gate_colors.py')]
PORT_TOOL = [sys.executable, '-m', 'viewformer_tpu_torch.tools.quality_gate']
# the port's --regate and --combine run in this process (no torch import of
# their own); the JAX tool runs as its tests run it
BLOCKED = ('jax', 'flax', 'viewformer_tpu', 'tools')

# Loaded by every Python process that has its directory on PYTHONPATH: an
# import of a BLOCKED package raises and is written to BLOCK_LOG.
# TensorFlow is absent too, as on the card's machine (tensorboard then
# takes its stub; here TensorFlow would cost ~20 s a process).
SITECUSTOMIZE = '''
import os, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.partition('.')[0] in {blocked!r}:
            with open(os.environ['BLOCK_LOG'], 'a') as f:
                f.write(name + '\\n')
            raise ModuleNotFoundError('blocked: ' + name, name=name)
        return None
sys.meta_path.insert(0, _Block())
sys.modules['tensorflow'] = None
'''.format(blocked=BLOCKED)

GOOD = [18.9, 21.9, 22.4, 22.7, 23.5, 23.3, 24.1, 24.4, 24.4, 24.6,
        25.4, 25.0, 25.1, 25.0, 25.1, 25.5, 25.8, 25.6, 26.1]
REGATE_CASES = {
    'good_run': (_report(26.1, 0.015, GOOD), [], 0),
    'flat_curve': (_report(26.1, 0.015, [24.0 + 0.1 * (i % 3) for i in range(19)]), [], 1),
    'inversion': (_report(26.1, 0.015, [20.0, 23.0, 19.0] + [23.0] * 16), [], 1),
    'low_psnr': (_report(18.0, 0.015, [18.0 + 0.3 * i for i in range(19)]), [], 1),
    'threshold_flags': (_report(20.0, 0.03, [18.0 + 0.2 * i for i in range(19)]),
                        ['--min-psnr', '19', '--max-ori', '0.05', '--min-ctx-gain', '3'], 0),
}


def _run(cmd, **kwargs):
    return subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, **kwargs)


@pytest.mark.parametrize('case', sorted(REGATE_CASES))
def test_regate_matches_jax_tool(tmp_path, case):
    report, extra, expected_rc = REGATE_CASES[case]
    src = tmp_path / 'report.json'
    src.write_text(json.dumps(report))
    jax_out, port_out = tmp_path / 'jax.json', tmp_path / 'port.json'
    jax_rc = _run(JAX_TOOL + ['--regate', str(src), '--out', str(jax_out)] + extra,
                  timeout=60).returncode
    port_rc = quality_gate.main(['--regate', str(src), '--out', str(port_out)] + extra)
    jax_report, port_report = json.loads(jax_out.read_text()), json.loads(port_out.read_text())
    assert port_rc == jax_rc == expected_rc
    assert port_report['gate'] == jax_report['gate']
    assert port_report['ok'] == jax_report['ok']
    if case == 'good_run':
        assert port_report['gate']['ctx_gain'] == 7.2


def test_combine_matches_jax_tool(tmp_path):
    a, b = tmp_path / 'a.json', tmp_path / 'b.json'
    a.write_text(json.dumps(_seed_report(42, 25.0, 0.016, 5.8)))
    b.write_text(json.dumps(_seed_report(1337, 24.0, 0.018, 5.0)))
    jax_out, port_out = tmp_path / 'jax.json', tmp_path / 'port.json'
    proc = _run(JAX_TOOL + ['--combine', str(a), str(b), '--out', str(jax_out)], timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert quality_gate.main(['--combine', str(a), str(b), '--out', str(port_out)]) == 0
    combined = {'jax': json.loads(jax_out.read_text()),
                'port': json.loads(port_out.read_text())}
    # no explicit --out: refused, so that a committed report is not overwritten
    assert _run(JAX_TOOL + ['--combine', str(a), str(b)], timeout=60).returncode != 0
    with pytest.raises(SystemExit) as refused:
        quality_gate.main(['--combine', str(a), str(b)])
    assert refused.value.code != 0
    for key in ('seeds', 'spread', 'worst', 'thresholds_in_force', 'thresholds_derived', 'ok'):
        assert combined['port'][key] == combined['jax'][key], key
    assert combined['port']['thresholds_derived']['min_psnr'] == 22.6
    assert combined['port']['ok'] is True


def test_quick_gate_on_cpu_without_jax(tmp_path):
    block = tmp_path / 'block'
    block.mkdir()
    (block / 'sitecustomize.py').write_text(SITECUSTOMIZE)
    log = tmp_path / 'blocked.log'
    log.write_text('')
    launches = tmp_path / 'launches.jsonl'
    env = dict(os.environ, OMP_NUM_THREADS='1', BLOCK_LOG=str(log),
               VIEWFORMER_LAUNCH_COUNTS=str(launches),
               PYTHONPATH=os.pathsep.join([str(block), ROOT]))
    out = tmp_path / 'report.json'
    proc = _run(PORT_TOOL + ['--quick', '--device', 'cpu', '--workdir', str(tmp_path / 'wd'),
                             '--out', str(out)], env=env, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(out.read_text())
    assert {'config', 'timings_s', 'transformer_eval', 'codebook_eval', 'multictx_eval',
            'finetune', 'gate', 'ok', 'card', 'transformer_eval_fp32'} <= set(report)
    assert report['ok'] is None and report['card'] is None
    quick_psnr = json.loads(proc.stdout.strip().splitlines()[-1])['quick_psnr']
    assert math.isfinite(quick_psnr) and quick_psnr == report['transformer_eval']['psnr']
    assert report['transformer_eval_fp32'] == report['transformer_eval']  # f32 on the CPU
    assert len(report['gate']['psnr_by_context']) == 3  # 4-frame sequences
    # the loops stop at --total-steps, not at the epoch count; the finetune
    # leg's steps continue from the restored one
    assert report['last_logged_step'] == {'codebook': 8, 'transformer': 8, 'finetune': 12}
    assert report['finetune']['schedules_continue_from_restored_step']
    assert report['finetune']['first_logged_step'] > 8
    assert set(report['timings_s']) == {
        'dataset/generate', 'train/codebook', 'generate-codes', 'train/transformer',
        'evaluate/transformer', 'evaluate/codebook', 'evaluate/transformer-multictx',
        'train/finetune-transformer', 'evaluate/transformer-finetuned'}
    assert log.read_text() == '', f'imported: {log.read_text()}'
    # each stage that loaded the kernels' module appended its launches at
    # exit: none on the CPU, where the plain versions run
    stages = [json.loads(line) for line in launches.read_text().splitlines()]
    assert [' '.join(stage['argv'][:2]) for stage in stages] == [
        'train codebook', 'train transformer', 'evaluate transformer', 'evaluate codebook',
        'evaluate transformer-multictx', 'train finetune-transformer', 'evaluate transformer']
    assert all(len(stage['launches']) == 8 and not any(stage['launches'].values())
               for stage in stages)


def test_gate_refuses_to_start_without_cuda(tmp_path):
    wd = tmp_path / 'wd'
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = _run(PORT_TOOL + ['--quick', '--workdir', str(wd)], env=env, timeout=120)
    assert proc.returncode != 0
    assert 'CUDA' in proc.stderr
    assert not wd.exists()  # before the dataset stage
