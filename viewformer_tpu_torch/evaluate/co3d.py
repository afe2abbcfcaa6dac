"""`evaluate co3d`: the official CO3D novel-view-synthesis harness over the
port's predictions (port of viewformer_tpu/evaluate/co3d.py).

Runs facebookresearch's co3d code (data/loaders/co3d.py: placed under
~/.cache/viewformer/co3d by hand; it imports pytorch3d) and the `lpips`
package: dataset_zoo and dataloader_zoo give the test batches, eval_batch
scores each prediction and summarize_nvs_eval_results /
aggregate_nvs_results reduce them, so the numbers are the CO3D paper's.
"""
import copy
import json
import os

import numpy as np
import torch

from ..data.loaders.co3d import CO3DLoader, _co3d_code
from ..utils.device import resolve_device
from .transformer import generate_batch_predictions, load_models


def evaluate_co3d(path, transformer_checkpoint, codebook_checkpoint, job_dir='.',
                  categories=None, single_sequence_evaluation=False, num_workers=16,
                  progress=True, use_bfloat16=True, device='cuda'):
    """The multisequence task over `categories` (default the harness's first
    10 of CO3D_CATEGORIES): prints each category's metrics, writes
    results-co3d.json (the harness's per-category results) and results.json
    ({'<subset>_<subsubset>': metrics}, returned) to job_dir. Each test batch
    puts its target frame first; the prediction takes the other frames as
    context. Runs on `device`: the card unless the caller asks for the CPU.

    single_sequence_evaluation and num_workers are accepted and unused, as in
    the JAX package and the reference, whose task is always
    'multisequence'."""
    from tqdm import tqdm

    device = resolve_device(device)
    transformer, codebook = load_models(transformer_checkpoint, codebook_checkpoint,
                                        use_bfloat16, device)
    loader = CO3DLoader(path=path, split='test', mask_images=True)
    with _co3d_code():
        from dataset.dataset_zoo import CO3D_CATEGORIES, dataset_zoo
        from dataset.dataloader_zoo import dataloader_zoo
        from eval_demo import _print_aggregate_results, aggregate_nvs_results
        from evaluation.evaluate_new_view_synthesis import (
            NewViewSynthesisPrediction, eval_batch, pretty_print_nvs_metrics,
            summarize_nvs_eval_results)

        def generate_predictions(frame_data):
            images = loader._process_rgb_image(frame_data).permute(0, 2, 3, 1).numpy()
            images = (images * 255.0).astype(np.uint8)
            matrices = frame_data.camera.get_world_to_view_transform().get_matrix() \
                .permute(0, 2, 1).numpy()
            cameras = loader.world_to_camera_to_cameras(matrices)
            # CO3D batches put the target first; the prediction takes it last
            images = np.concatenate((images[1:], images[:1]), 0)[None]
            cameras = np.concatenate((cameras[1:], cameras[:1]), 0)[None]
            preds = generate_batch_predictions(transformer, codebook, images, cameras)
            predicted = torch.from_numpy(
                preds['generated_images'].astype(np.float32)).permute(0, 3, 1, 2) / 255.0
            return NewViewSynthesisPrediction(
                image_render=predicted,
                mask_render=torch.ones((1, 1) + predicted.shape[-2:], dtype=torch.float32),
                depth_render=torch.zeros((1, 1) + predicted.shape[-2:], dtype=torch.float32))

        def evaluate_for_category(category, bg_color='black'):
            task = 'multisequence'
            # the harness draws its test batches from torch's global
            # generator: seeding it here gives the JAX package's and the
            # reference's batches
            torch.manual_seed(42)
            datasets = dataset_zoo(dataset_root=path, category=category,
                                   assert_single_seq=False,
                                   dataset_name=f'co3d_{task}', test_on_train=False,
                                   load_point_clouds=True, test_restrict_sequence_id=None)
            test_dataloader = dataloader_zoo(datasets, dataset_name=f'co3d_{task}')['test']

            import lpips as lpips_pkg
            lpips_model = lpips_pkg.LPIPS(net='vgg')
            if device.type == 'cuda':
                lpips_model = lpips_model.to(device)

            per_batch_eval_results = []
            for frame_data in tqdm(test_dataloader) if progress else test_dataloader:
                preds = generate_predictions(frame_data)
                per_batch_eval_results.append(eval_batch(
                    frame_data, copy.deepcopy(preds), bg_color=bg_color,
                    lpips_model=lpips_model, source_cameras=None))
            _flat, category_result = summarize_nvs_eval_results(per_batch_eval_results, task)
            return category_result['results']

        task = 'multisequence'
        task_results = {task: []}
        if categories is None:
            categories = CO3D_CATEGORIES[:10]
        for category in categories:
            category_result = evaluate_for_category(category)
            print(f'\nResults for task={task}; category={category}:')
            pretty_print_nvs_metrics(category_result)
            task_results[task].append(category_result)
            _print_aggregate_results(task, task_results)

        os.makedirs(job_dir, exist_ok=True)
        with open(os.path.join(job_dir, 'results-co3d.json'), 'w') as f:
            json.dump(task_results, f)
        result = {f"{x['subset']}_{x['subsubset']}": x['metrics']
                  for x in aggregate_nvs_results(task_results[task])}
        with open(os.path.join(job_dir, 'results.json'), 'w') as f:
            json.dump(result, f)
        return result
