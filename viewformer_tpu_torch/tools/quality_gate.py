#!/usr/bin/env python3
"""The colors quality gate of the port: the whole product trained and
evaluated through `python -m viewformer_tpu_torch` at the reference model
sizes on the hermetic colors fixture, then gated on end-to-end quality.

    python -m viewformer_tpu_torch.tools.quality_gate [--seed 42] [--device cuda]

Stages, each a subprocess of the port's CLI, timed: dataset generate (200
sequences x 20 frames at 128 px, shards of 32) -> train codebook (6000
steps, batch 32, lr 1.44e-4, perceptual weight 0) -> generate-codes (batch
64) -> train transformer (4000 steps, batch 10, lr 3e-4) -> evaluate
transformer, evaluate codebook and evaluate transformer-multictx on 24 test
sequences -> the finetune leg (1000 more steps at lr 1e-4, then evaluate
transformer) -> evaluate transformer once more in f32 (`--fp32`, on the
CPU, as the card's kernels take bf16), a reading that is not gated. The gate:

    psnr       >= --min-psnr      (24.2)
    loc-angle  <= --max-ori       (0.0194 rad)
    the PSNR-by-context curve of `evaluate transformer-multictx` rises by
    at least --min-ctx-gain (4.4 dB) from context 1 to the largest, and no
    adjacent pair dips by more than --mono-slack (0.75 dB)

and, off --quick, the finetune leg: its first logged step lies past the
restored step (the schedules continue) and its PSNR is within 1 dB of the
base run's. The thresholds and step counts are those of the JAX package's
gate, calibrated there on two seeds (worst seed minus seed spread minus
evaluation noise); a branching-attention mask that leaks future frames or
drops context flattens the context curve to about 0 gain.

The report goes to QUALITY_torch_seed<seed>.json at the checkout's root:
config, timings_s, transformer_eval, codebook_eval, multictx_eval,
finetune, gate and ok, the card (`nvidia-smi`), the codebook's initial
draw (init: 'jax', the JAX package's draw of the seed), transformer_eval_fp32
and each job's last logged train step. Exit code 0 when the gate passes.

--device (default cuda) goes to every stage that takes it; the tool raises
before the first stage when it names CUDA and no card is present, and never
falls back to the CPU. With --device cpu every stage also gets --fp32.
--quick shrinks every stage (12 sequences of 8 frames at 32 px, 8 steps,
a 1-layer transformer; on a card 128 px, heads 64 wide and 2 layers) to
check the harness, not quality: its report (`ok` null) goes to
the workdir unless --out names a file. --regate REPORT
recomputes the verdict of a report and --combine A B merges two seeds'
reports with their spread and the thresholds they imply; both need --out.
The full gate takes ~45 min on one H100: start it detached and read
the stage times from its output (each stage's own output is kept under
<workdir>/logs).
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_cli(args, env, log_dir, name, timings, timeout=7200):
    """`python -m viewformer_tpu_torch ARGS` from the checkout's root, its
    output kept in log_dir/<name>.log and its seconds in timings[name];
    raises with the output's tail when it fails."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, name.replace('/', '_') + '.log')
    print('>>', name, ' '.join(args[:6]), '...', flush=True)
    t0 = time.time()
    with open(path, 'w') as out:
        code = subprocess.run([sys.executable, '-m', 'viewformer_tpu_torch'] + args, env=env,
                              cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
                              timeout=timeout).returncode
    dt = time.time() - t0
    if code != 0:
        with open(path) as f:
            tail = f.read()[-6000:]
        raise RuntimeError(f'CLI failed ({name}, exit code {code}):\n{tail}')
    print(f'   done in {dt:.0f}s', flush=True)
    timings[name] = round(dt, 1)


def require_device(device):
    """Raises SystemExit when `device` names CUDA and no card is present."""
    if device.startswith('cuda'):
        import torch
        if not torch.cuda.is_available():
            raise SystemExit(f'quality_gate: --device {device}, but torch.cuda.is_available() '
                             'is false (no CUDA device); pass --device cpu to run on the CPU')


def card_name():
    """`name, power.limit` of the card(s) as nvidia-smi gives them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()


def last_train_step(job_dir, first=False):
    """The step of the last (or first) `train/loss` record of a job's
    metrics.jsonl."""
    step = None
    with open(os.path.join(job_dir, 'metrics.jsonl')) as f:
        for line in f:
            record = json.loads(line)
            if 'train/loss' in record or 'train/total_loss' in record:
                step = record['step']
                if first:
                    break
    return step


def read_results(job_dir):
    with open(os.path.join(job_dir, 'results.json')) as f:
        return json.load(f)


def sizes(args):
    """(image size, sequences, frames a sequence, codebook steps,
    transformer steps, codebook flags, transformer flags, eval sequences)."""
    if args.quick:
        args.finetune_steps = min(args.finetune_steps, 4)
        # the JAX tool's --quick sizes; on a card the kernels' shapes, frames
        # of 8x8 tokens (128 px through the codebook's 16x reduction) and
        # heads 64 wide, and 2 layers: the last layer's stream 0 feeds no
        # loss, so one layer would run no block-causal backward (B6)
        card = args.device != 'cpu'
        image = '128' if card else '32'
        return (int(image), 12, 8, 8, 8,
                ['--ch', '32', '--num-res-blocks', '1', '--n-embed', '64', '--embed-dim', '8',
                 '--batch-size', '4', '--epochs', '2', '--image-size', image,
                 '--perceptual-weight', '0'],
                ['--d-model', '64' if card else '32', '--n-layer', '2' if card else '1',
                 '--n-head', '1' if card else '2', '--sequence-size', '4',
                 '--token-image-size', '8' if card else '2', '--n-loss-skip', '1',
                 '--batch-size', '2', '--epochs', '2'],
                4)
    # VQGANConfig() and MIGTConfig() (12 layers, d 768). The codebook's lr is
    # the reference's 4.5e-6 an image at this batch of 32 (taming's
    # base_lr x batch); perceptual weight 0, as no LPIPS weights are present.
    return (128, 200, 20, args.codebook_steps, args.transformer_steps,
            ['--batch-size', '32', '--epochs', '10', '--learning-rate', '1.44e-4',
             '--perceptual-weight', '0'],
            ['--batch-size', '10', '--epochs', '10', '--learning-rate', '3e-4'],
            24)


def run_gate(args):
    """The stages, then the verdict; writes the report. Returns the exit code."""
    require_device(args.device)
    wd = args.workdir or os.path.join(
        tempfile.gettempdir(), 'quality_torch_quick' if args.quick else 'quality_torch')
    if args.out is None:
        args.out = (os.path.join(wd, 'QUALITY_torch_quick.json') if args.quick
                    else os.path.join(REPO, f'QUALITY_torch_seed{args.seed}.json'))
    os.makedirs(wd, exist_ok=True)
    env = dict(os.environ)  # OMP_NUM_THREADS and the like pass on to the stages
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    image_size, n_seq, seq_len, cb_steps, tr_steps, cb_extra, tr_extra, eval_n = sizes(args)
    device = ['--device', args.device] + (['--fp32'] if args.device == 'cpu' else [])
    report = {'config': {'image_size': image_size, 'n_sequences': n_seq,
                         'codebook_steps': cb_steps, 'transformer_steps': tr_steps,
                         'finetune_steps': args.finetune_steps, 'seed': args.seed,
                         'device': args.device},
              'card': None if args.device == 'cpu' else card_name(),
              # train codebook --seed S starts from the JAX package's draw
              'init': 'jax',
              'timings_s': {}}
    timings = report['timings_s']
    sfx = '' if args.seed == 42 else f'_s{args.seed}'
    log_dir = os.path.join(wd, 'logs' + sfx)

    def cli(name, cli_args):
        run_cli(cli_args, env, log_dir, name, timings)

    # the dataset is the fixture, shared by the seeds; one of another size
    # (a --quick run's in this workdir) is made anew
    ds = os.path.join(wd, 'img')
    ds_ok = False
    info_path = os.path.join(ds, 'info.json')
    if os.path.exists(info_path):
        with open(info_path) as f:
            info = json.load(f)
        ds_ok = (info.get('frame_size') == image_size and info.get('train_num_sequences') == n_seq
                 and info.get('train_sequence_size') == seq_len)
        if not ds_ok:
            print(f'   stale cached dataset in {ds} (frame_size={info.get("frame_size")}, '
                  f'want {image_size}): regenerating', flush=True)
            shutil.rmtree(ds, ignore_errors=True)
    if not ds_ok:
        cli('dataset/generate',
            ['dataset', 'generate', '--loader', 'colors', '--loader-num-sequences', str(n_seq),
             '--loader-sequence-size', str(seq_len), '--loader-image-size', str(image_size),
             '--output', os.path.join(ds, 'colors'), '--max-sequences-per-shard', '32',
             '--split', 'train', '--split', 'test'])

    # fresh job dirs: the trainers resume a job dir they find
    cb_job = os.path.join(wd, 'codebook' + sfx)
    codes = os.path.join(wd, 'codes' + sfx)
    tr_job = os.path.join(wd, 'transformer' + sfx)
    ft_job = tr_job + '_ft'
    evals = {kind: os.path.join(wd, kind + sfx) for kind in
             ('eval', 'eval_codebook', 'eval_multictx', 'eval_finetune', 'eval_fp32')}
    for path in [cb_job, codes, tr_job, ft_job] + list(evals.values()):
        shutil.rmtree(path, ignore_errors=True)

    cli('train/codebook',
        ['train', 'codebook', '--dataset', ds, '--job-dir', cb_job, '--total-steps',
         str(cb_steps), '--seed', str(args.seed)] + cb_extra + device)
    cli('generate-codes',
        ['generate-codes', '--dataset', ds, '--output', codes, '--model', cb_job,
         '--batch-size', '64'] + device)
    cli('train/transformer',
        ['train', 'transformer', '--dataset', codes, '--codebook-model', cb_job, '--job-dir',
         tr_job, '--total-steps', str(tr_steps), '--seed', str(args.seed)] + tr_extra + device)

    def evaluate(name, kind, transformer, job_dir, flags):
        models = (['--transformer-model', transformer] if transformer else []) + [
            '--codebook-model', cb_job, '--job-dir', job_dir]
        cli(name, ['evaluate', kind, '--loader', 'dataset', '--loader-path', ds,
                   '--loader-split', 'test'] + models + flags)
        return read_results(job_dir)

    sequences = ['--batch-size', str(min(eval_n, 8)), '--num-eval-sequences', str(eval_n)]
    results = evaluate('evaluate/transformer', 'transformer', tr_job, evals['eval'],
                       sequences + ['--num-store-images', '8'] + device)
    cb_results = evaluate('evaluate/codebook', 'codebook', None, evals['eval_codebook'],
                          ['--batch-size', '16', '--num-eval-images', str(eval_n * 4)] + device)
    # one pass gives the PSNR of every context size: the curve of the gate
    mc_results = evaluate('evaluate/transformer-multictx', 'transformer-multictx', tr_job,
                          evals['eval_multictx'], sequences + ['--num-store-images', '0'] + device)
    report.update(transformer_eval=results, codebook_eval=cb_results, multictx_eval=mc_results)

    # the finetune leg: the base job continued for --finetune-steps steps at
    # an overridden lr; its first logged step must lie past the restored
    # step (the schedules continue) and its PSNR within noise of the base's
    if args.finetune_steps:
        ft_flags = ['--learning-rate', '1e-4']
        ft_flags += (['--batch-size', '2', '--epochs', '1'] if args.quick else
                     ['--batch-size', '10', '--epochs', '2', '--codebook-model', cb_job])
        cli('train/finetune-transformer',
            ['train', 'finetune-transformer', '--dataset', codes, '--checkpoint', tr_job,
             '--job-dir', ft_job, '--total-steps', str(tr_steps + args.finetune_steps)]
            + ft_flags + device)
        first_step = last_train_step(ft_job, first=True)
        ft_results = evaluate('evaluate/transformer-finetuned', 'transformer', ft_job,
                              evals['eval_finetune'], sequences + ['--num-store-images', '0']
                              + device)
        schedules_continue = first_step is not None and first_step > tr_steps
        psnr_within_noise = args.quick or (
            ft_results.get('psnr') is not None and results.get('psnr') is not None
            and ft_results['psnr'] >= results['psnr'] - 1.0)
        report['finetune'] = {
            'steps': args.finetune_steps, 'overrides': {'learning_rate': 1e-4},
            'restored_from_step': tr_steps, 'first_logged_step': first_step,
            'schedules_continue_from_restored_step': bool(schedules_continue),
            'eval': ft_results, 'psnr_base': results.get('psnr'),
            'psnr_finetuned': ft_results.get('psnr'),
            'psnr_within_noise_of_base': bool(psnr_within_noise),
            'ok': bool(schedules_continue and psnr_within_noise)}
        print(json.dumps({k: v for k, v in report['finetune'].items() if k != 'eval'}),
              flush=True)

    # not gated: the base job in f32 beside the evaluation above, which is
    # bf16 on a card; the card's kernels take bf16, so f32 runs on the CPU
    # (with --device cpu the evaluation above is this one)
    report['transformer_eval_fp32'] = results if args.device == 'cpu' else evaluate(
        'evaluate/transformer-fp32', 'transformer', tr_job, evals['eval_fp32'],
        sequences + ['--num-store-images', '0', '--fp32', '--device', 'cpu'])
    report['last_logged_step'] = {
        'codebook': last_train_step(cb_job), 'transformer': last_train_step(tr_job),
        'finetune': last_train_step(ft_job) if args.finetune_steps else None}

    apply_gate(report, results, cb_results, mc_results, args)
    if report.get('finetune') is not None and not args.quick:
        report['ok'] = bool(report['ok'] and report['finetune']['ok'])
    if args.quick:
        report['ok'] = None  # the harness is checked, not the quality
    with open(args.out, 'w') as f:
        json.dump(report, f, indent=1)
    print('wrote', args.out, flush=True)
    if args.quick:
        print(json.dumps({'quick_psnr': results.get('psnr')}), flush=True)
        return 0
    print('QUALITY GATE ' + ('PASSED' if report['ok'] else 'FAILED'), flush=True)
    return 0 if report['ok'] else 1


def ctx_order(key):
    """Numeric order of context-size keys ('ctx1' < 'ctx2' < 'ctx10')."""
    digits = ''.join(c for c in key if c.isdigit())
    return int(digits) if digits else 0


def apply_gate(report, results, cb_results, mc_results, args):
    """report['gate'] and report['ok'] from the evaluations. The curve's
    adjacent pairs carry about +-0.4 dB of noise at 24 evaluation
    sequences, so the per-pair slack screens inversions only; the overall
    rise is the sharp signal."""
    psnr_by_ctx = {ctx: m.get('psnr') for ctx, m in mc_results.items()}
    curve = [psnr_by_ctx[k] for k in sorted(psnr_by_ctx, key=ctx_order)]
    mono_ok = (len(curve) >= 2 and all(v is not None for v in curve)
               and all(curve[i + 1] >= curve[i] - args.mono_slack
                       for i in range(len(curve) - 1))
               and curve[-1] - curve[0] >= args.min_ctx_gain)
    report['gate'] = {'min_psnr': args.min_psnr, 'max_ori': args.max_ori,
                      'mono_slack': args.mono_slack, 'min_ctx_gain': args.min_ctx_gain,
                      'psnr': results.get('psnr'), 'loc_angle': results.get('loc-angle'),
                      'psnr_by_context': psnr_by_ctx,
                      'ctx_gain': (round(curve[-1] - curve[0], 3)
                                   if curve and None not in (curve[0], curve[-1]) else None),
                      'psnr_monotone_in_context': bool(mono_ok)}
    print(json.dumps(report['gate']), flush=True)
    psnr, ori = results.get('psnr'), results.get('loc-angle')
    report['ok'] = bool(psnr is not None and ori is not None and psnr >= args.min_psnr
                        and ori <= args.max_ori and mono_ok)
    return report['ok']


def regate(args):
    with open(args.regate) as f:
        report = json.load(f)
    missing = [k for k in ('transformer_eval', 'codebook_eval', 'multictx_eval')
               if k not in report]
    if missing:
        sys.exit(f'--regate: report lacks eval sections {missing} (a --quick report?)')
    ok = apply_gate(report, report['transformer_eval'], report['codebook_eval'],
                    report['multictx_eval'], args)
    with open(args.out, 'w') as f:
        json.dump(report, f, indent=1)
    print('wrote', args.out, flush=True)
    print('QUALITY GATE ' + ('PASSED' if ok else 'FAILED'), flush=True)
    return 0 if ok else 1


def combine(args):
    """Two seeds' reports in one: both, their spread, the worst seed's
    values and the thresholds they imply (worst seed minus seed spread minus
    0.4 dB of evaluation noise a curve endpoint; loc-angle plus spread plus
    20%)."""
    reports = []
    for path in args.combine:
        with open(path) as f:
            reports.append(json.load(f))
    for r, path in zip(reports, args.combine):
        for key in ('gate', 'ok', 'transformer_eval'):
            if key not in r:
                sys.exit(f'--combine: {path} lacks {key!r} (a --quick report?)')
    seeds = [str(r['config'].get('seed', '?')) for r in reports]
    psnrs = [r['gate']['psnr'] for r in reports]
    gains = [r['gate']['ctx_gain'] for r in reports]
    oris = [r['gate']['loc_angle'] for r in reports]
    combined = {
        'protocol': 'two independent seeds at the 6k/4k gate config; thresholds derive from '
                    'worst-seed minus noise (adjacent multictx pairs carry ~+-0.4 dB at 24 '
                    'eval sequences; the measured seed spread bounds trajectory variance)',
        'seeds': dict(zip(seeds, reports)),
        'init': sorted({str(r.get('init')) for r in reports}),
        'spread': {'psnr_db': round(abs(psnrs[0] - psnrs[1]), 3),
                   'ctx_gain_db': round(abs(gains[0] - gains[1]), 3),
                   'loc_angle_rad': round(abs(oris[0] - oris[1]), 5)},
        'worst': {'psnr_db': round(min(psnrs), 3), 'ctx_gain_db': round(min(gains), 3),
                  'loc_angle_rad': round(max(oris), 5)},
        'thresholds_in_force': {'min_psnr': args.min_psnr, 'max_ori': args.max_ori,
                                'min_ctx_gain': args.min_ctx_gain,
                                'mono_slack': args.mono_slack},
        'thresholds_derived': {
            'rule': 'worst-seed minus seed spread minus eval noise '
                    '(0.4 dB/curve endpoint at 24 eval sequences)',
            'min_psnr': round(min(psnrs) - abs(psnrs[0] - psnrs[1]) - 0.4, 1),
            'min_ctx_gain': round(min(gains) - abs(gains[0] - gains[1]) - 0.8, 1),
            'max_ori': round(max(oris) + abs(oris[0] - oris[1]) + 0.2 * max(oris), 4)},
        'ok': bool(all(r['ok'] for r in reports)),
    }
    with open(args.out, 'w') as f:
        json.dump(combined, f, indent=1)
    print(json.dumps({k: combined[k] for k in ('spread', 'worst', 'thresholds_in_force',
                                               'thresholds_derived', 'ok')}, indent=1),
          flush=True)
    print('wrote', args.out, flush=True)
    return 0 if combined['ok'] else 1


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workdir', default=None,
                    help='datasets, job dirs and stage logs (default: quality_torch or '
                         'quality_torch_quick under the temporary directory)')
    ap.add_argument('--seed', type=int, default=42,
                    help='init and data-order seed of the trainers; job dirs of another seed '
                         'than 42 get a _s<seed> suffix, the dataset is shared')
    ap.add_argument('--device', default='cuda',
                    help="where every stage runs: a CUDA device (default) or 'cpu'")
    ap.add_argument('--codebook-steps', type=int, default=6000)
    ap.add_argument('--transformer-steps', type=int, default=4000)
    ap.add_argument('--finetune-steps', type=int, default=1000,
                    help='length of the finetune leg (0: none)')
    ap.add_argument('--min-psnr', type=float, default=24.2)
    ap.add_argument('--max-ori', type=float, default=0.0194)
    ap.add_argument('--mono-slack', type=float, default=0.75)
    ap.add_argument('--min-ctx-gain', type=float, default=4.4)
    ap.add_argument('--regate', metavar='REPORT.json',
                    help="recompute a report's verdict (needs --out)")
    ap.add_argument('--combine', nargs=2, metavar='REPORT.json',
                    help="merge two seeds' reports (needs --out)")
    ap.add_argument('--quick', action='store_true',
                    help='tiny stages: checks the harness, not quality')
    ap.add_argument('--out', default=None,
                    help='the report (default: QUALITY_torch_seed<seed>.json at the root; '
                         'with --quick, in the workdir); required for --regate/--combine')
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if (args.regate or args.combine) and args.out is None:
        # a committed report is never overwritten by a threshold experiment
        ap.error('--regate/--combine require an explicit --out')
    if args.combine:
        return combine(args)
    if args.regate:
        return regate(args)
    return run_gate(args)


if __name__ == '__main__':
    sys.exit(main())
