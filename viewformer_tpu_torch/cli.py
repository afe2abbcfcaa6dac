"""The port's command line (`python -m viewformer_tpu_torch`), on argparse:

  dataset generate              write a loader's sequences as an image dataset
  train codebook                train the VQ-GAN codebook on an image dataset
  generate-codes                encode an image dataset into a token dataset
  train transformer             train MIGT on a token dataset
  train finetune-transformer    continue a trained transformer's job
  evaluate transformer          novel-view synthesis and localization metrics
  evaluate transformer-multictx the metrics of every context size, one pass
  evaluate codebook             the codebook's reconstruction metrics
  serve                         the JSONL serving protocol (commands/serve.py)

The flags are those of the JAX package's commands (viewformer_tpu/cli.py),
without the TPU-only --steps-per-call, --seq-parallelism and
--force-wide-scan, with --remat-policy full only, without --wandb for the
codebook, and with --device (default cuda) where a model runs. `dataset
generate` and the evaluate commands take `--loader NAME` and pass every
`--loader-<param> VALUE` (or `--loader-<param>=VALUE`) to the loader as
<param>=VALUE, parsed as a bool, int or float where it reads as one. The
evaluate commands and generate-codes compute in bf16 (the card's kernels
take bf16) unless given --fp32, as serve does. The other commands of the
JAX package are not ported yet.
"""
import argparse
import dataclasses
import sys

from .config import MIGTConfig, VQGANConfig, load_config
from .utils.schedules import Schedule

# MIGTConfig fields settable from `train transformer`: (flag, type)
_TRANSFORMER_OPTIONS = (
    ('learning-rate', float), ('d-model', int), ('n-layer', int), ('n-head', int),
    ('sequence-size', int), ('token-image-size', int), ('n-loss-skip', int),
    ('augment-poses', str), ('localization-weight', str), ('pose-multiplier', float),
    ('random-pose-multiplier', float), ('label-smoothing', float), ('weight-decay', float),
    ('gradient-clip-val', float), ('dropout', float))
# VQGANConfig fields settable from `train codebook`
_CODEBOOK_OPTIONS = (
    ('learning-rate', float), ('n-embed', int), ('embed-dim', int), ('image-size', int),
    ('ch', int), ('num-res-blocks', int), ('gradient-clip-val', float),
    ('perceptual-weight', float))
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


def _parse_value(value):
    lowered = value.lower()
    if lowered in ('true', 'false'):
        return lowered == 'true'
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            continue
    return value


def _split_loader_args(argv):
    """(argv without its --loader-<param> flags, {param: value})."""
    rest, loader_kwargs = [], {}
    args = iter(argv)
    for arg in args:
        if not arg.startswith('--loader-'):
            rest.append(arg)
            continue
        key, sep, value = arg[len('--loader-'):].partition('=')
        if not sep:
            value = next(args, None)
            if value is None:
                raise SystemExit(f'{arg} needs a value')
        loader_kwargs[key.replace('-', '_')] = _parse_value(value)
    return rest, loader_kwargs


def _add_evaluate_common(parser, transformer=True):
    parser.add_argument('--loader', dest='loader_name', default='dataset')
    if transformer:
        parser.add_argument('--transformer-model', required=True)
    parser.add_argument('--codebook-model', required=True)
    parser.add_argument('--job-dir', required=True)
    parser.add_argument('--num-store-images', type=int, default=100)
    parser.add_argument('--image-size', type=int, default=None)
    parser.add_argument('--fp32', action='store_true',
                        help='f32 weights (for the CPU: the card\'s kernels take bf16)')
    parser.add_argument('--device', default='cuda',
                        help="where to evaluate: a CUDA device (default) or 'cpu'")
    if transformer:
        parser.add_argument('--batch-size', type=int, default=1)
        parser.add_argument('--num-eval-sequences', type=int, default=None)
        parser.add_argument('--pose-multiplier', type=float, default=None)
        parser.add_argument('--sequence-size', type=int, default=None)
        parser.add_argument('--store-ctx', action='store_true')


def _parser():
    parser = argparse.ArgumentParser(prog='python -m viewformer_tpu_torch')
    groups = parser.add_subparsers(dest='group', required=True)

    dataset = groups.add_parser('dataset', help='datasets').add_subparsers(dest='command',
                                                                          required=True)
    generate = dataset.add_parser('generate',
                                  help='Write TFRecord shards from a sequence loader.')
    generate.add_argument('--loader', dest='loader_name', required=True)
    generate.add_argument('--output', required=True,
                          help='<directory>/<dataset name> of the shards')
    generate.add_argument('--split', dest='splits', action='append', default=None,
                          help='a split to write (repeatable; default train and test)')
    generate.add_argument('--max-images-per-shard', type=int, default=None)
    generate.add_argument('--max-sequences-per-shard', type=int, default=None)
    generate.add_argument('--image-size', type=int, default=None)
    generate.add_argument('--shuffle', action=argparse.BooleanOptionalAction, default=False)
    generate.add_argument('--shards', default=None, help='SplitIndices subset, e.g. "1:5"')
    generate.add_argument('--allow-incompatible-config', action='store_true')
    generate.set_defaults(run=_dataset_generate)

    generate_codes = groups.add_parser('generate-codes',
                                       help='Encode an image dataset into codebook tokens.')
    generate_codes.add_argument('--dataset', required=True)
    generate_codes.add_argument('--output', required=True)
    generate_codes.add_argument('--model', required=True, help='job dir of the codebook')
    generate_codes.add_argument('--batch-size', type=int, default=None)
    generate_codes.add_argument('--shards', default=None)
    generate_codes.add_argument('--split', dest='splits', action='append', default=None)
    generate_codes.add_argument('--fp32', action='store_true',
                                help='encode in f32, not bf16')
    generate_codes.add_argument('--device', default='cuda',
                                help="where to encode: a CUDA device (default) or 'cpu'")
    generate_codes.set_defaults(run=_generate_codes)

    train = groups.add_parser('train', help='training').add_subparsers(dest='command',
                                                                        required=True)
    codebook = train.add_parser('codebook', help='Train the VQ-GAN codebook (stage 1).')
    codebook.add_argument('--dataset', dest='dataset_path', required=True)
    codebook.add_argument('--job-dir', required=True)
    codebook.add_argument('--total-steps', type=int, default=None)
    codebook.add_argument('--epochs', type=int, default=100)
    codebook.add_argument('--batch-size', type=int, default=None)
    for flag, kind in _CODEBOOK_OPTIONS:
        codebook.add_argument(f'--{flag}', type=kind, default=None)
    codebook.add_argument('--accumulate-grad-batches', type=int, default=1)
    codebook.add_argument('--log-every', type=int, default=50)
    codebook.add_argument('--checkpoint-every', type=int, default=None,
                          help='extra mid-epoch rolling-last saves every N steps')
    codebook.add_argument('--fp32', action='store_true', help='compute in f32, not bf16')
    codebook.add_argument('--seed', type=int, default=42, help='init and data-order seed')
    codebook.add_argument('--resume', action=argparse.BooleanOptionalAction, default=True)
    codebook.add_argument('--device', default='cuda',
                          help="where to train: a CUDA device (default) or 'cpu'")
    codebook.set_defaults(run=_train_codebook)

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

    evaluate = groups.add_parser('evaluate', help='evaluation').add_subparsers(
        dest='command', required=True)
    single = evaluate.add_parser('transformer',
                                 help='Single-context novel view synthesis evaluation.')
    _add_evaluate_common(single)
    single.set_defaults(run=_evaluate_transformer)
    multictx = evaluate.add_parser('transformer-multictx',
                                   help='All-context-sizes-at-once evaluation.')
    _add_evaluate_common(multictx)
    multictx.set_defaults(run=_evaluate_multictx)
    codebook = evaluate.add_parser('codebook', help='Codebook reconstruction evaluation.')
    _add_evaluate_common(codebook, transformer=False)
    codebook.add_argument('--batch-size', type=int, default=64)
    codebook.add_argument('--num-eval-images', type=int, default=None)
    codebook.set_defaults(run=_evaluate_codebook)

    serve = groups.add_parser(
        'serve', help='KV-cache serving session: JSON requests on stdin, responses on stdout '
                      '(the protocol is in viewformer_tpu_torch/commands/serve.py).')
    serve.add_argument('--transformer-model', required=True)
    serve.add_argument('--codebook-model', required=True)
    serve.add_argument('--max-frames', type=int, default=None,
                       help='context capacity (default: model sequence_size - 1)')
    serve.add_argument('--pose-multiplier', type=float, default=None)
    serve.add_argument('--fp32', action='store_true', help='disable bf16 serving weights')
    serve.add_argument('--device', default='cuda',
                       help="where to serve: a CUDA device (default) or 'cpu'")
    serve.set_defaults(run=_serve)
    return parser


def _dataset_generate(args):
    from .data.dataset import generate_dataset_from_loader
    from .data.loaders import get_loader
    for split in args.splits or ['train', 'test']:
        kwargs = dict(args.loader_kwargs)
        kwargs.setdefault('split', split)
        if args.shuffle:
            kwargs['shuffle'] = True
        if args.image_size is not None:
            kwargs['image_size'] = args.image_size
        generate_dataset_from_loader(
            get_loader(args.loader_name)(**kwargs), split, args.output,
            max_images_per_shard=args.max_images_per_shard,
            max_sequences_per_shard=args.max_sequences_per_shard, shards=args.shards,
            allow_incompatible_config=args.allow_incompatible_config)


def _train_codebook(args):
    from .train.codebook import train_codebook
    options = {_field(flag): getattr(args, _field(flag)) for flag, _ in _CODEBOOK_OPTIONS}
    config = VQGANConfig.from_dict({k: v for k, v in options.items() if v is not None})
    if args.total_steps:
        config.total_steps = args.total_steps
    if args.batch_size:
        config.batch_size = args.batch_size
    train_codebook(config, args.dataset_path, args.job_dir, total_steps=config.total_steps,
                   epochs=args.epochs, batch_size=config.batch_size,
                   accumulate_grad_batches=args.accumulate_grad_batches,
                   log_every=args.log_every, checkpoint_every=args.checkpoint_every,
                   seed=args.seed, resume=args.resume, use_bf16=not args.fp32,
                   device=args.device)


def _generate_codes(args):
    from .commands.generate_codes import generate_codes
    generate_codes(args.dataset, args.output, args.model, shards=args.shards,
                   batch_size=args.batch_size, splits=args.splits,
                   use_bfloat16=not args.fp32, device=args.device)


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


def _loader(args):
    """image_size -> the test split of the --loader, with the
    --loader-<param> arguments."""
    from .data.loaders import get_loader

    def build(image_size):
        kwargs = dict(args.loader_kwargs)
        kwargs.setdefault('split', 'test')
        if image_size is not None:
            kwargs['image_size'] = image_size
        return get_loader(args.loader_name)(**kwargs)
    return build


def _evaluate_kwargs(args):
    return dict(batch_size=args.batch_size, num_eval_sequences=args.num_eval_sequences,
                pose_multiplier=args.pose_multiplier, sequence_size=args.sequence_size,
                num_store_images=args.num_store_images, store_ctx=args.store_ctx,
                image_size=args.image_size, use_bfloat16=not args.fp32, device=args.device)


def _evaluate_transformer(args):
    from .evaluate.transformer import evaluate_transformer
    evaluate_transformer(_loader(args), args.transformer_model, args.codebook_model,
                         args.job_dir, **_evaluate_kwargs(args))


def _evaluate_multictx(args):
    from .evaluate.multictx import evaluate_transformer_multictx
    evaluate_transformer_multictx(_loader(args), args.transformer_model, args.codebook_model,
                                  args.job_dir, **_evaluate_kwargs(args))


def _evaluate_codebook(args):
    from .evaluate.codebook import evaluate_codebook
    evaluate_codebook(_loader(args), args.codebook_model, args.job_dir,
                      batch_size=args.batch_size, num_eval_images=args.num_eval_images,
                      num_store_images=args.num_store_images, image_size=args.image_size,
                      use_bfloat16=not args.fp32, device=args.device)


def _serve(args):
    from .commands.serve import serve_loop
    serve_loop(args.transformer_model, args.codebook_model, max_frames=args.max_frames,
               use_bfloat16=not args.fp32, pose_multiplier=args.pose_multiplier,
               device=args.device)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    loader_kwargs = {}
    if argv[:1] in (['evaluate'], ['dataset']):
        argv, loader_kwargs = _split_loader_args(argv)
    args = _parser().parse_args(argv)
    args.loader_kwargs = loader_kwargs
    args.run(args)
