"""`evaluate transformer-multictx-allimg`: every frame of a sequence as the
query against one fixed context (port of
viewformer_tpu/evaluate/multictx_allimg.py). Each query runs the one-shot
MIGT.forward over three streams (B1, and B2's one-shot form over two
branches), which gives its render from every context size at once. With
keep_last_frame the queries run one after another, each with the previous
query's generated frame in front of its context. Writes the gen/gt/ctx
image tree under <job_dir>/gen_images/<sequence id>/.
"""
import os

import numpy as np
import torch

from ..ops.image import normalize_images, upload_frames
from .evaluator import MultiContextEvaluator, print_metrics
from .transformer import (_png, from_relative_cameras, load_models, normalize_cameras,
                          to_relative_cameras, write_results)


def make_transformer_predict(transformer):
    """-> predict(cameras [B, S, 7], codes [B, S, h, w]) (numpy) ->
    (generated cameras [B, S, 7] or None without localization, generated
    codes [B, S, h, w]) as numpy: position t rendered from the first t
    frames, all for the last frame's camera."""
    use_localization = transformer.use_localization
    relative = transformer.config.augment_poses == 'relative'
    device = transformer.wte.weight.device

    @torch.inference_mode()
    def predict(cameras, codes):
        cameras = torch.as_tensor(np.asarray(cameras, np.float32), device=device)
        codes = torch.as_tensor(np.asarray(codes), device=device)
        transform = None
        if relative:
            cameras, transform = to_relative_cameras(cameras)
        cameras = normalize_cameras(cameras)
        B, S = codes.shape[:2]
        input_ids = torch.cat([codes[:, :-1],
                               torch.full_like(codes[:, :1], transformer.mask_token)], 1)
        context_cameras = torch.cat([cameras[:, :-1], torch.zeros_like(cameras[:, :1])], 1)
        query_cameras = cameras[:, -1:].expand(B, S, 7)
        query_tokens = codes[:, -1:].expand((B, S) + tuple(codes.shape[2:]))
        out = transformer(context_cameras, input_ids,
                          localization_tokens=query_tokens if use_localization else None,
                          output_poses=query_cameras)
        generated_codes = out['logits'].argmax(-1).cpu().numpy()
        generated_cameras = None
        if use_localization:
            generated_cameras = transformer.reduce_cameras(out['pose_prediction'])
            if relative:
                generated_cameras = from_relative_cameras(generated_cameras, transform)
            generated_cameras = generated_cameras.float().cpu().numpy()
        return generated_cameras, generated_codes

    return predict


def run_with_batchsize(fn, batch_size, *args):
    """fn over leading-axis chunks of batch_size of args, its outputs (an
    array, or a tuple of arrays or None) concatenated."""
    outs = [fn(*(x[i:i + batch_size] for x in args))
            for i in range(0, len(args[0]), batch_size)]
    if not isinstance(outs[0], tuple):
        return np.concatenate(outs, 0)
    return tuple(None if outs[0][j] is None else np.concatenate([o[j] for o in outs], 0)
                 for j in range(len(outs[0])))


def evaluate_transformer_multictx_allimg(loader, transformer_checkpoint, codebook_checkpoint,
                                         job_dir, context_views=None, pose_multiplier=None,
                                         keep_last_frame=False, image_size=None,
                                         num_eval_sequences=None, progress=True,
                                         use_bfloat16=True, device='cuda'):
    """The metrics of every context size over every frame of the loader's
    sequences (or a callable image_size -> loader) as query, with the frames
    context_views (default a numpy default_rng(42) sample of sequence_size
    - 1 a sequence) as context. Writes results.json and the image tree,
    prints the results and returns them. Runs on `device`: the card unless
    the caller asks for the CPU."""
    transformer, codebook = load_models(transformer_checkpoint, codebook_checkpoint,
                                        use_bfloat16, device, pose_multiplier)
    if callable(loader) and not hasattr(loader, '__getitem__'):
        loader = loader(codebook.config.image_size)
    model_device = transformer.wte.weight.device

    @torch.inference_mode()
    def encode_images(frames):
        x = normalize_images(upload_frames(frames, codebook.config.image_size, model_device))
        _, codes = codebook.encode(x.reshape((-1,) + tuple(x.shape[2:])))
        return codes.cpu().numpy().reshape(frames.shape[:2] + tuple(codes.shape[1:]))

    @torch.inference_mode()
    def decode_code(generated_codes):
        B, S = generated_codes.shape[:2]
        codes = torch.as_tensor(generated_codes.reshape((B * S,) + generated_codes.shape[2:]),
                                device=model_device)
        dec = ((codebook.decode_code(codes).clamp(-1, 1) / 2 + 0.5) * 255.0 + 0.5)
        dec = dec.to(torch.uint8).cpu().numpy()
        return dec.reshape((B, S) + dec.shape[1:])

    predict = make_transformer_predict(transformer)
    n_context_views = (len(context_views) if context_views is not None
                       else transformer.config.sequence_size - 1)
    evaluator = MultiContextEvaluator(n_context_views + 1, image_size=image_size, device=device)
    rng = np.random.default_rng(42)

    total = num_eval_sequences if num_eval_sequences is not None else len(loader)
    for seq_idx in range(total):
        seq = loader[seq_idx]
        sequence_id = seq.get('sequence_id', f'{seq_idx:06d}')
        c_context_views = context_views
        if c_context_views is None:
            c_context_views = list(rng.choice(len(seq['frames']), (n_context_views,),
                                              replace=False))
        c_context_views = [int(x) for x in c_context_views]
        frames = np.asarray(seq['frames'])[None]
        cameras = np.asarray(seq['cameras'])[None].astype(np.float32)
        codes = encode_images(frames)
        n_frames = frames.shape[1]
        # one query a frame: the context views, then the frame
        tcodes = np.concatenate([np.stack([codes[:, j] for j in c_context_views + [i]], 1)
                                 for i in range(n_frames)], 0)
        tcameras = np.concatenate([np.stack([cameras[:, j] for j in c_context_views + [i]], 1)
                                   for i in range(n_frames)], 0)

        if keep_last_frame:
            # query i's context starts with query i - 1's generated frame
            generated_codes, generated_cameras = [], []
            last_frame = None
            for i in range(tcodes.shape[0]):
                lcodes, lcameras = tcodes[i:i + 1], tcameras[i:i + 1]
                if last_frame is not None:
                    lcodes = np.concatenate([last_frame[0], lcodes], 1)
                    lcameras = np.concatenate([last_frame[1], lcameras], 1)
                lgcameras, lgcodes = predict(lcameras, lcodes)
                if last_frame is not None:
                    lgcodes = lgcodes[:, 1:]
                    if lgcameras is not None:
                        lgcameras = lgcameras[:, 1:]
                generated_codes.append(lgcodes)
                generated_cameras.append(lgcameras)
                last_frame = (lgcodes[:, -1:], lcameras[:, -1:])
            generated_codes = np.concatenate(generated_codes, 0)
            generated_cameras = (None if generated_cameras[0] is None
                                 else np.concatenate(generated_cameras, 0))
        else:
            generated_cameras, generated_codes = run_with_batchsize(predict, 128, tcameras,
                                                                    tcodes)

        generated_images = run_with_batchsize(decode_code, 64, generated_codes)
        eval_frames = [x for x in range(len(generated_images)) if x not in c_context_views]
        evaluator.update_state(
            ground_truth_cameras=np.stack([cameras[0, x] for x in eval_frames], 0),
            ground_truth_images=np.stack([frames[0, x] for x in eval_frames], 0),
            generated_images=np.stack([generated_images[x] for x in eval_frames], 0),
            generated_cameras=(None if generated_cameras is None
                               else np.stack([generated_cameras[x] for x in eval_frames], 0)))

        base = os.path.join(job_dir, 'gen_images', str(sequence_id))
        for i in range(1 + len(c_context_views)):
            os.makedirs(os.path.join(base, f'gen-{i:02d}'), exist_ok=True)
        os.makedirs(os.path.join(base, 'gt'), exist_ok=True)
        os.makedirs(os.path.join(base, 'ctx'), exist_ok=True)
        for i, c in enumerate(c_context_views):
            _png(os.path.join(base, 'ctx', f'{i:02d}-{c:03d}.png'), frames[0, c])
        for i in range(n_frames):
            _png(os.path.join(base, 'gt', f'{i:03d}.png'), frames[0, i])
        for i, per_ctx in enumerate(generated_images):
            for j, img in enumerate(per_ctx):
                _png(os.path.join(base, f'gen-{j:02d}', f'{i:03d}.png'), img)
        if progress:
            print(f'sequence {seq_idx + 1} of {total}: ' + ' '.join(
                f'{k}={v:.4f}' for k, v in evaluator.get_progress_bar_info().items()),
                flush=True)
        if seq_idx % 20 == 0:
            write_results(job_dir, evaluator.result())

    result = evaluator.result()
    write_results(job_dir, result)
    print('Results:')
    print_metrics(result)
    return result
