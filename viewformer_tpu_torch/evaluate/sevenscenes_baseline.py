"""`evaluate 7scenes-baseline`: localization baselines without a model
(port of viewformer_tpu/evaluate/sevenscenes_baseline.py), over the contexts
`evaluate 7scenes` draws: the mean context camera (positions averaged,
quaternions by their eigenvector mean), or the context camera nearest to
the query by position or by orientation (oracles). numpy on the host.
"""
import os
import random
from collections import OrderedDict

import numpy as np

from ..data.loaders._wrappers import FixedSequenceSizeLoader
from ..data.loaders.sevenscenes import ALL_SCENES, SevenScenesLoader
from ..utils import metrics as M
from ..utils import np_geometry
from .sevenscenes import SceneLookup, _print_scene, load_image_match_map
from .transformer import write_results


class LocalizationEvaluator:
    """The localization metrics of Evaluator (the same results.json keys)."""

    def __init__(self):
        self._metrics = [M.CameraOrientationError('loc-angle'),
                         M.CameraPositionError('loc-dist'),
                         M.CameraOrientationMedian('loc-angle-med'),
                         M.CameraPositionMedian('loc-dist-med')]

    def update_state(self, ground_truth_cameras, generated_cameras):
        for metric in self._metrics:
            metric.update_state(np.asarray(generated_cameras), np.asarray(ground_truth_cameras))

    def get_progress_bar_info(self):
        result = {m.name: float(m.result()) for m in self._metrics}
        return OrderedDict([('cam_loc', result['loc-dist']), ('cam_ang', result['loc-angle'])])

    def result(self):
        return OrderedDict((m.name, float(m.result())) for m in self._metrics)


def _camera_distances(db_cameras, camera, position):
    """Position distances (position) or rotation angles from db_cameras
    [N, 7] to camera [..., 7]."""
    if position:
        return np.linalg.norm(db_cameras[..., :3] - camera[..., :3], axis=-1)
    x1 = np_geometry.quaternion_normalize(db_cameras[..., 3:])
    x2 = np_geometry.quaternion_normalize(camera[..., 3:])
    diff = np_geometry.quaternion_multiply(
        x1, np.broadcast_to(np_geometry.quaternion_conjugate(x2), x1.shape))
    return 2 * np.arcsin(np.clip(np.linalg.norm(diff[..., 1:], axis=-1), 0, 1))


def generate_batch_predictions_baseline(cameras, baseline):
    """cameras [1, S, 7] (context, then the query) -> the baseline's camera
    for the query: 'mean', 'position_oracle' or 'orientation_oracle'."""
    ctx_cameras, gt_cameras = cameras[0, :-1], cameras[:, -1]
    if baseline == 'mean':
        xyz = ctx_cameras[..., :3].mean(0)
        quat = np_geometry.quaternion_average(ctx_cameras[..., 3:])
        pred = np.concatenate((xyz, quat), -1)
    else:
        assert baseline in ('position_oracle', 'orientation_oracle')
        idx = int(np.argmin(_camera_distances(ctx_cameras, gt_cameras,
                                              baseline == 'position_oracle')))
        pred = ctx_cameras[idx]
    return dict(ground_truth_cameras=gt_cameras, generated_cameras=pred[None])


def evaluate_sevenscenes_baseline(path, job_dir, image_match_map=None, scenes=None,
                                  num_eval_sequences=1000, top_n_matched_images=0,
                                  baseline='position_oracle', progress=True):
    """`python -m viewformer_tpu_torch evaluate 7scenes-baseline`: the
    baseline's localization metrics on each scene's test frames, with 19
    context frames as `evaluate 7scenes` draws them. Writes
    <job_dir>/<scene>/results.json and <job_dir>/results.json and returns
    {scene: results}."""
    if scenes is None:
        scenes = ALL_SCENES
    if top_n_matched_images > 0:
        assert image_match_map is not None

    all_results = {}
    for scene in scenes:
        top_match_map = None
        if image_match_map is not None:
            top_match_map = load_image_match_map(image_match_map.format(scene=scene))
        scene_lookup = SceneLookup(path, scene)
        rng = random.Random(42)

        evaluator = LocalizationEvaluator()
        test_loader = FixedSequenceSizeLoader(
            SevenScenesLoader(path=path, split='test', scenes=[scene], _load_file_paths=True), 1)
        indices = random.Random(42).sample(
            list(range(len(test_loader))), min(len(test_loader), num_eval_sequences))
        for done, index in enumerate(indices, 1):
            batch = test_loader[index]
            ctx = []
            if top_match_map is not None:
                ctx = top_match_map[batch['frames_files'][0] + '.color.png'][:top_n_matched_images]
            ctx = list(ctx) + rng.sample(scene_lookup.files, 19 - len(ctx))
            ctx_cameras = np.stack([scene_lookup.camera(x) for x in ctx], 0)
            cameras = np.concatenate((ctx_cameras, np.asarray(batch['cameras'])), 0)[None]
            evaluator.update_state(**generate_batch_predictions_baseline(cameras, baseline))
            if progress:
                print(f'{scene}: {done} of {len(indices)} queries: ' + ' '.join(
                    f'{k}={v:.4f}' for k, v in evaluator.get_progress_bar_info().items()),
                    flush=True)
        result = evaluator.result()
        all_results[scene] = result
        _print_scene(scene, result)
        write_results(os.path.join(job_dir, scene), result, indent=None)
    write_results(job_dir, all_results, indent=None)
    return all_results
