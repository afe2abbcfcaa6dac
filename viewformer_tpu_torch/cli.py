"""The port's command line (`python -m viewformer_tpu_torch`), on argparse:

  train transformer             train MIGT on a token dataset
  train finetune-transformer    continue a trained transformer's job

The flags are those of the JAX package's commands (viewformer_tpu/cli.py),
without the TPU-only --steps-per-call, --seq-parallelism and
--force-wide-scan, with --remat-policy full only, and with --device (default
cuda). The other commands are not ported yet.
"""
import argparse
import dataclasses

from .config import MIGTConfig, load_config
from .utils.schedules import Schedule

# MIGTConfig fields settable from `train transformer`: (flag, type)
_TRANSFORMER_OPTIONS = (
    ('learning-rate', float), ('d-model', int), ('n-layer', int), ('n-head', int),
    ('sequence-size', int), ('token-image-size', int), ('n-loss-skip', int),
    ('augment-poses', str), ('localization-weight', str), ('pose-multiplier', float),
    ('random-pose-multiplier', float), ('label-smoothing', float), ('weight-decay', float),
    ('gradient-clip-val', float), ('dropout', float))
# and from `train finetune-transformer`
_FINETUNE_OPTIONS = (
    ('learning-rate', float), ('pose-multiplier', float), ('localization-weight', str),
    ('sequence-size', int), ('n-loss-skip', int))


def _field(flag):
    return flag.replace('-', '_')


def _add_common(parser):
    parser.add_argument('--dataset', dest='dataset_path', required=True)
    parser.add_argument('--job-dir', required=True)
    parser.add_argument('--total-steps', type=int, default=None)
    parser.add_argument('--epochs', type=int, default=100)
    parser.add_argument('--batch-size', type=int, default=None)
    parser.add_argument('--checkpoint-every', type=int, default=None,
                        help='extra mid-epoch rolling-last saves every N steps')
    parser.add_argument('--fp32', action='store_true', help='compute in f32, not bf16')
    parser.add_argument('--wandb', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="where to train: a CUDA device (default) or 'cpu'")


def _parser():
    parser = argparse.ArgumentParser(prog='python -m viewformer_tpu_torch')
    groups = parser.add_subparsers(dest='group', required=True)
    train = groups.add_parser('train', help='training').add_subparsers(dest='command',
                                                                        required=True)

    transformer = train.add_parser('transformer', help='Train the MIGT transformer (stage 2).')
    _add_common(transformer)
    transformer.add_argument('--codebook-model', required=True,
                             help='job dir of the codebook (sets n_embeddings; validation '
                                  'PSNR and image grids)')
    for flag, kind in _TRANSFORMER_OPTIONS:
        transformer.add_argument(f'--{flag}', type=kind, default=None)
    transformer.add_argument('--max-samples-per-environment', type=int, default=-1)
    # Parsed and not passed on: the JAX package's scripts give --remat-policy
    # full, which is what train_transformer always does (remat=True).
    transformer.add_argument('--remat-policy', choices=['full'], default='full',
                             help='per-block remat: full recomputes each block in the '
                                  'backward (the only policy ported)')
    transformer.add_argument('--seed', type=int, default=42, help='init and data-order seed')
    transformer.add_argument('--resume', action=argparse.BooleanOptionalAction, default=True)
    transformer.set_defaults(run=_train_transformer)

    finetune = train.add_parser(
        'finetune-transformer',
        help='Finetune a trained transformer: its parameters, AdamW state and step carry '
             'over, so the schedules continue.')
    _add_common(finetune)
    finetune.add_argument('--checkpoint', required=True, help='job dir of the base transformer')
    finetune.add_argument('--codebook-model', default=None,
                          help='optional codebook job dir for validation PSNR and image grids')
    for flag, kind in _FINETUNE_OPTIONS:
        finetune.add_argument(f'--{flag}', type=kind, default=None)
    finetune.set_defaults(run=_finetune_transformer)
    return parser


def _train_transformer(args):
    from .train.transformer import train_transformer
    options = {_field(flag): getattr(args, _field(flag)) for flag, _ in _TRANSFORMER_OPTIONS}
    config = MIGTConfig.from_dict({k: v for k, v in options.items() if v is not None})
    config.n_embeddings = load_config(args.codebook_model).n_embed
    if args.total_steps:
        config.total_steps = args.total_steps
    if args.batch_size:
        config.batch_size = args.batch_size
    train_transformer(config, args.dataset_path, args.job_dir, codebook_path=args.codebook_model,
                      total_steps=config.total_steps, epochs=args.epochs,
                      batch_size=config.batch_size, resume=args.resume, seed=args.seed,
                      use_bf16=not args.fp32, wandb=args.wandb,
                      max_samples_per_environment=args.max_samples_per_environment,
                      checkpoint_every=args.checkpoint_every, device=args.device)


def _finetune_transformer(args):
    from .train.transformer import train_transformer
    config = load_config(args.checkpoint)
    overrides = {}
    for flag, _ in _FINETUNE_OPTIONS:
        value = getattr(args, _field(flag))
        if value is not None:
            overrides[_field(flag)] = (Schedule.from_str(value)
                                       if flag == 'localization-weight' else value)
    config = dataclasses.replace(config, **overrides)
    if args.total_steps:
        config.total_steps = args.total_steps
    if args.batch_size:
        config.batch_size = args.batch_size
    train_transformer(config, args.dataset_path, args.job_dir, finetune_from=args.checkpoint,
                      total_steps=config.total_steps, epochs=args.epochs,
                      batch_size=config.batch_size, use_bf16=not args.fp32, wandb=args.wandb,
                      codebook_path=args.codebook_model, checkpoint_every=args.checkpoint_every,
                      device=args.device)


def main(argv=None):
    args = _parser().parse_args(argv)
    args.run(args)
