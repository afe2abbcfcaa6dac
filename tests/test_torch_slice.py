"""The port's serving slice end to end against the JAX package, its
independence from the JAX package (serving, train steps without and with
dropout and under the 'attn' remat policy, the reader, checkpoints and
train_transformer with a resume, a
serving session, the colors loader and the three evaluators, the tiny
pipeline dataset generate -> train codebook -> generate-codes -> train
transformer -> evaluate codebook through the CLI, dataset shuffle and
visualize codebook --output, ArchiveStore and the
7-Scenes loader, the 7-Scenes, allimg and generate-gqn-images
evaluators, a released-layout codebook installed by pull_checkpoint and
read by load_model, and the native host codecs, the fork decode pool and the
parity harness, with viewformer_tpu, jax and flax blocked, one part a
subprocess), and chip_smoke.py's refusal to run without a card."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_serve import CCONFIG, TCONFIG
from test_torch_config import to_port
from viewformer_tpu.evaluate import transformer as jev
from viewformer_tpu.models.migt import MIGT
from viewformer_tpu.models.vqgan import VQGAN
from viewformer_tpu_torch.evaluate import transformer as tev
from viewformer_tpu_torch.models import AutoModel
from viewformer_tpu_torch.ops import attention_cuda
from viewformer_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(config, variables):
    model = AutoModel.from_config(to_port(config), device='cpu',
                                 generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(model, variables))
    return model


def test_generate_batch_predictions_matches_jax():
    cmodel, tmodel = VQGAN(CCONFIG), MIGT(TCONFIG)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    cvars = cmodel.init({'params': k1, 'quantizer': k2},
                        jnp.zeros((1, 32, 32, 3), jnp.float32), training=False)
    tvars = tmodel.init(k3, jnp.zeros((1, 5, 7), jnp.float32),
                        jnp.zeros((1, 5, 16, 16), jnp.int32), compute_losses=False)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 4, 32, 32, 3)).astype(np.uint8)
    cameras = rng.randn(2, 4, 7).astype(np.float32)
    cameras[..., 3:] /= np.linalg.norm(cameras[..., 3:], axis=-1, keepdims=True)

    expected = jev.generate_batch_predictions(tmodel, tvars, cmodel, cvars, images, cameras,
                                              _cache=jev.JitCallCache())
    attention_cuda.reset_launch_counts()
    port = tev.generate_batch_predictions(_port(TCONFIG, jax.device_get(tvars)),
                                          _port(CCONFIG, jax.device_get(cvars)),
                                          images, cameras)
    assert port['generated_images'].dtype == np.uint8
    assert port['generated_images'].shape == expected['generated_images'].shape
    diff = np.abs(port['generated_images'].astype(int) - expected['generated_images'])
    assert diff.max() <= 1
    np.testing.assert_allclose(port['generated_cameras'], expected['generated_cameras'],
                               atol=1e-4)
    np.testing.assert_array_equal(port['ground_truth_cameras'],
                                  expected['ground_truth_cameras'])
    np.testing.assert_array_equal(port['ground_truth_images'], images[:, -1])
    # on the CPU the slice took the plain attention: no kernel launch counted
    assert all(fn.launches == 0 for fn in attention_cuda.KERNELS)


# The port with viewformer_tpu, jax and flax blocked, in parts: each part is
# one subprocess, its own case, on one intra-op thread, with its own time
# limit. Every part ends by asserting that none of the three was imported.
_PRELUDE = """
import os, sys
sys.modules['jax'] = None
sys.modules['flax'] = None
sys.modules['viewformer_tpu'] = None
sys.path.insert(0, {root!r})
import numpy as np, torch
torch.set_num_threads(1)
from viewformer_tpu_torch.config import MIGTConfig, VQGANConfig
from viewformer_tpu_torch.models import AutoModel
gen = torch.Generator().manual_seed(0)
rng = np.random.RandomState(0)
out = {out!r}

def tiny_models():
    codebook = AutoModel.from_config(VQGANConfig(ch=32, ch_mult=[1, 2], num_res_blocks=1,
        attn_resolutions=[8], z_channels=32, embed_dim=8, n_embed=16, image_size=16),
        device='cpu', generator=gen)
    transformer = AutoModel.from_config(MIGTConfig(n_embeddings=16, n_head=2, d_model=32,
        n_layer=2, token_image_size=8), device='cpu', generator=gen)
    return transformer, codebook

def save_jobs(transformer, codebook):
    from viewformer_tpu_torch.train.checkpoint import CheckpointManager
    jobs = {{}}
    for name, model in (('t', transformer), ('c', codebook)):
        jobs[name] = os.path.join(out, name)
        mgr = CheckpointManager(jobs[name], model.config)
        mgr.save(0, {{'model': model.state_dict()}})
        mgr.close()
    return jobs

def loader(size):
    from viewformer_tpu_torch.data.loaders import build
    return build('colors', split='test', num_sequences=2, sequence_size=3, image_size=size)

def image_dataset(path, num_sequences=2, sequence_size=5, size=16):
    from viewformer_tpu_torch.data.dataset import generate_dataset_from_loader
    from viewformer_tpu_torch.data.loaders import build
    for split in ('train', 'test'):
        generate_dataset_from_loader(build('colors', split=split, num_sequences=num_sequences,
            sequence_size=sequence_size, image_size=size), split, os.path.join(path, 'colors'),
            max_sequences_per_shard=1, progress=False)
    return path
"""

_EPILOGUE = """
assert not any(m.split('.')[0] in ('jax', 'flax', 'viewformer_tpu') for m in sys.modules
               if sys.modules[m])
print('ran without jax and viewformer_tpu')
"""

_PARTS = {}
_PARTS['imports_and_serving'] = """
import importlib, pkgutil
import viewformer_tpu_torch
for info in pkgutil.walk_packages(viewformer_tpu_torch.__path__, 'viewformer_tpu_torch.'):
    importlib.import_module(info.name)
from viewformer_tpu_torch.evaluate.transformer import generate_batch_predictions
transformer, codebook = tiny_models()
result = generate_batch_predictions(transformer, codebook,
    rng.randint(0, 256, (1, 3, 16, 16, 3)).astype(np.uint8),
    rng.randn(1, 3, 7).astype(np.float32))
assert result['generated_images'].shape == (1, 16, 16, 3)
assert np.isfinite(result['generated_cameras']).all()
"""
_PARTS['train_steps'] = """
import dataclasses
from viewformer_tpu_torch.train.transformer import (init_transformer_state,
    make_transformer_train_step, process_batch)
config = MIGTConfig(n_embeddings=16, n_head=2, d_model=32, n_layer=2, dropout=0.0,
    sequence_size=3, token_image_size=2, n_loss_skip=1, localization_weight='1')
model, state = init_transformer_state(config, gen, dtype=torch.float32, device='cpu')
cameras, tokens = process_batch(rng.randn(3, 7).astype(np.float32),
    rng.randint(0, 16, (3, 2, 2)), 'relative', 'train')
state, metrics = make_transformer_train_step(model, config)(
    state, (torch.from_numpy(cameras)[None], torch.from_numpy(tokens)[None]))
assert state.step == 1 and np.isfinite(float(metrics['loss']))
config = dataclasses.replace(config, dropout=0.1)
model, state = init_transformer_state(config, gen, dtype=torch.float32, device='cpu')
state, metrics = make_transformer_train_step(model, config)(
    state, (torch.from_numpy(cameras)[None], torch.from_numpy(tokens)[None]),
    torch.Generator().manual_seed(1))
assert state.step == 1 and np.isfinite(float(metrics['loss']))
model, state = init_transformer_state(config, gen, dtype=torch.float32, device='cpu',
    remat_policy='attn')
state, metrics = make_transformer_train_step(model, config)(
    state, (torch.from_numpy(cameras)[None], torch.from_numpy(tokens)[None]),
    torch.Generator().manual_seed(1))
assert state.step == 1 and np.isfinite(float(metrics['loss']))
import torch.distributed as dist
from viewformer_tpu_torch.parallel.mesh import create_mesh, current_mesh
from viewformer_tpu_torch.parallel.sharding import shard_transformer_state
dist.init_process_group('gloo', init_method='file://' + os.path.join(out, 'rendezvous'),
    rank=0, world_size=1)
mesh = create_mesh(1, 1, seq_parallelism=1)
assert current_mesh() is mesh
model, state = init_transformer_state(config, gen, dtype=torch.float32, device='cpu')
shard_transformer_state(model, state, mesh)
state, metrics = make_transformer_train_step(model, config)(
    state, (torch.from_numpy(cameras)[None], torch.from_numpy(tokens)[None]),
    torch.Generator().manual_seed(1))
assert state.step == 1 and np.isfinite(float(metrics['loss']))
dist.destroy_process_group()
"""
_PARTS['train_loop_with_resume'] = """
from viewformer_tpu_torch.data.dataset import write_dataset_info, write_shard
from viewformer_tpu_torch.train.transformer import train_transformer
config = MIGTConfig(n_embeddings=16, n_head=2, d_model=32, n_layer=2, dropout=0.1,
    sequence_size=3, token_image_size=2, n_loss_skip=1, localization_weight='1')
data = os.path.join(out, 'data')
os.makedirs(data)
write_dataset_info(os.path.join(data, 'info.json'), dict(name='d', token_image_size=2,
    features=['cameras', 'codes'], train_size=1, test_size=1, splits=['train', 'test']))
for split in ('train', 'test'):
    write_shard(os.path.join(data, 'd-%s-000001-of-000001' % split),
        [dict(cameras=rng.randn(7, 7), codes=rng.randint(0, 16, (7, 2, 2)))] * 2,
        ['cameras', 'codes'])
job = os.path.join(out, 'job')
kwargs = dict(epochs=1, batch_size=2, checkpoint_every=1, use_bf16=False, progress=False,
    device='cpu')
_, state = train_transformer(config, data, job, total_steps=2, **kwargs)
assert state.step == 2 and os.listdir(os.path.join(job, 'last')) == ['2.pt']
_, state = train_transformer(config, data, job, total_steps=3, **kwargs)  # resumes at 2
assert state.step == 3
assert len(open(os.path.join(job, 'metrics.jsonl')).readlines()) == 4  # 3 train, 1 val
"""
_PARTS['session_and_evaluators'] = """
from viewformer_tpu_torch.serve import ServingSession
transformer, codebook = tiny_models()
session = ServingSession(transformer, codebook, batch_size=1, max_frames=3)
frames = rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8)
cams = rng.randn(3, 7).astype(np.float32)
session.start(frames[:2], cams[:2])
session.observe(frames[2], cams[2])
assert session.context_frames == 3
assert session.render(cams[None, :2]).shape == (1, 2, 16, 16, 3)
assert np.isfinite(session.localize(frames[None, 0])).all()
from viewformer_tpu_torch.evaluate.codebook import evaluate_codebook
from viewformer_tpu_torch.evaluate.multictx import evaluate_transformer_multictx
from viewformer_tpu_torch.evaluate.transformer import evaluate_transformer
jobs = save_jobs(transformer, codebook)
kwargs = dict(num_store_images=1, progress=False, use_bfloat16=False, device='cpu')
result = evaluate_transformer(loader, jobs['t'], jobs['c'], os.path.join(out, 'e1'),
    sequence_size=3, **kwargs)
assert result['lpips'] is None and result['psnr'] > 0 and np.isfinite(result['loc-dist'])
result = evaluate_transformer_multictx(loader, jobs['t'], jobs['c'], os.path.join(out, 'e2'),
    sequence_size=3, **kwargs)
assert list(result) == ['ctx01', 'ctx02'] and np.isfinite(result['ctx02']['psnr'])
result = evaluate_codebook(loader, jobs['c'], os.path.join(out, 'e3'), **kwargs)
assert np.isfinite(result['ssim'])
"""
_PARTS['cli_pipeline'] = """
import json
from PIL import Image
from viewformer_tpu_torch import cli
from viewformer_tpu_torch.models import lpips
lpips._WEIGHT_PATHS = [os.path.join(out, 'no-lpips.npz')]
images, cjob, codes, tjob = (os.path.join(out, n) for n in ('images', 'cjob', 'codes', 'tjob'))
cli.main(['dataset', 'generate', '--loader', 'colors', '--loader-num-sequences', '2',
    '--loader-sequence-size', '5', '--image-size', '16', '--output',
    os.path.join(images, 'colors'), '--max-sequences-per-shard', '1'])
cli.main(['train', 'codebook', '--dataset', images, '--job-dir', cjob, '--device', 'cpu',
    '--fp32', '--total-steps', '2', '--epochs', '1', '--batch-size', '5', '--ch', '32',
    '--num-res-blocks', '1', '--n-embed', '16', '--embed-dim', '8', '--image-size', '16'])
cli.main(['generate-codes', '--dataset', images, '--output', codes, '--model', cjob,
    '--device', 'cpu', '--fp32', '--batch-size', '4'])
cli.main(['train', 'transformer', '--dataset', codes, '--codebook-model', cjob, '--job-dir',
    tjob, '--device', 'cpu', '--fp32', '--total-steps', '2', '--epochs', '1',
    '--batch-size', '2', '--d-model', '32', '--n-layer', '2', '--n-head', '2',
    '--sequence-size', '5', '--token-image-size', '1', '--n-loss-skip', '1'])
assert sorted(os.listdir(os.path.join(tjob, 'last'))) == ['2.pt']
cli.main(['evaluate', 'codebook', '--loader', 'dataset', '--loader-path', images,
    '--codebook-model', cjob, '--job-dir', os.path.join(out, 'e4'), '--device', 'cpu',
    '--fp32', '--num-store-images', '0', '--batch-size', '5', '--num-eval-images', '5'])
result = json.load(open(os.path.join(out, 'e4', 'results.json')))
assert result['lpips'] is None and np.isfinite(result['psnr'])
cli.main(['dataset', 'shuffle', '--dataset', images, '--output', os.path.join(out, 'shuffled')])
assert sorted(os.listdir(os.path.join(out, 'shuffled'))) == sorted(os.listdir(images))
cli.main(['visualize', 'codebook', '--loader', 'dataset', '--loader-path', images,
    '--codebook-model', cjob, '--output', os.path.join(out, 'grid.png'), '--num-images', '4',
    '--device', 'cpu', '--fp32'])
assert Image.open(os.path.join(out, 'grid.png')).size == (8 * 16, 16)
"""
_PARTS['archives_and_sevenscenes'] = """
import io, zipfile
from PIL import Image
from viewformer_tpu_torch.data.archive import ArchiveStore
from viewformer_tpu_torch.data.loaders import get_loaders
from viewformer_tpu_torch.data.loaders.sevenscenes import SevenScenesLoader
from viewformer_tpu_torch.evaluate.generate_images import generate_gqn_images
from viewformer_tpu_torch.evaluate.multictx_allimg import evaluate_transformer_multictx_allimg
from viewformer_tpu_torch.evaluate.sevenscenes import evaluate_sevenscenes
from viewformer_tpu_torch.evaluate.sevenscenes_baseline import evaluate_sevenscenes_baseline
from viewformer_tpu_torch.evaluate.sevenscenes_multictx import evaluate_sevenscenes_multictx
assert len(get_loaders()) == 8
jobs = save_jobs(*tiny_models())
def seq_zip(n, x0):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, 'w') as z:
        for i in range(n):
            png = io.BytesIO()
            Image.fromarray(rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)).save(png, 'PNG')
            z.writestr('frame-%06d.color.png' % i, png.getvalue())
            pose = np.eye(4)
            pose[:3, 3] = [x0 + 0.1 * i, 0, 1]
            z.writestr('frame-%06d.pose.txt' % i, '\\n'.join(' '.join(map(str, r)) for r in pose))
    return buf.getvalue()
scenes = os.path.join(out, '7scenes')
os.makedirs(scenes)
with zipfile.ZipFile(os.path.join(scenes, 'chess.zip'), 'w') as z:
    z.writestr('chess/TrainSplit.txt', 'sequence1\\n')
    z.writestr('chess/TestSplit.txt', 'sequence2\\n')
    z.writestr('chess/seq-01.zip', seq_zip(20, 0.0))
    z.writestr('chess/seq-02.zip', seq_zip(2, 5.0))
with ArchiveStore(os.path.join(scenes, 'chess')) as archive:
    assert sorted(archive.ls('')) == ['TestSplit.txt', 'TrainSplit.txt', 'seq-01.zip', 'seq-02.zip']
assert SevenScenesLoader(scenes, split='train', scenes=['chess']).num_images_per_sequence() == [20]
kwargs = dict(scenes=['chess'], num_context_views=2, image_size=16, progress=False,
    use_bfloat16=False, device='cpu')
for procedure in ('standard', 'generated_images', 'pose_refinement'):
    result = evaluate_sevenscenes(scenes, jobs['t'], jobs['c'], os.path.join(out, procedure),
        generation_procedure=procedure, num_gen_ctx=1, batch_size=2, **kwargs)
    assert result['chess']['lpips'] is None and np.isfinite(result['chess']['loc-dist'])
result = evaluate_sevenscenes_multictx(scenes, jobs['t'], jobs['c'], os.path.join(out, 'e5'),
    **kwargs)
assert list(result['chess']) == ['ctx01', 'ctx02']
result = evaluate_sevenscenes_baseline(scenes, os.path.join(out, 'e6'), scenes=['chess'],
    baseline='mean', progress=False)
assert np.isfinite(result['chess']['loc-angle'])
result = evaluate_transformer_multictx_allimg(loader, jobs['t'], jobs['c'],
    os.path.join(out, 'e7'), context_views=[0], keep_last_frame=True, num_eval_sequences=1,
    progress=False, use_bfloat16=False, device='cpu')
assert np.isfinite(result['ctx01']['psnr'])
images = image_dataset(os.path.join(out, 'images'))
generate_gqn_images(images, os.path.join(out, 'e8'), jobs['t'], jobs['c'], num_eval_sequences=1,
    progress=False, use_bfloat16=False, device='cpu')
assert sorted(os.listdir(os.path.join(out, 'e8')))[-2:] == ['gen0.png', 'gt0.png']
"""
_PARTS['released_checkpoint'] = """
import re
from viewformer_tpu_torch.config import save_config
from viewformer_tpu_torch.models import load_model
from viewformer_tpu_torch.utils import pull_checkpoint
_, codebook = tiny_models()
reference = {}
for key, value in codebook.state_dict().items():
    key = re.sub(r'^(encoder|decoder)[.](down|up)_(\\d+)_(block|attn)_(\\d+)[.]', r'\\1.\\2.\\3.\\4.\\5.', key)
    key = re.sub(r'^(encoder|decoder)[.](down|up)_(\\d+)_(downsample|upsample)[.]', r'\\1.\\2.\\3.\\4.', key)
    key = re.sub(r'^(encoder|decoder)[.]mid_', r'\\1.mid.', key)
    reference[re.sub(r'^quantizer[.]', 'quantize.', key)] = value
released = os.path.join(out, 'released')
save_config(codebook.config, released)
torch.save({'state_dict': reference}, os.path.join(released, 'model.ckpt'))
os.environ['HOME'] = os.path.join(out, 'home')
pull_checkpoint('tiny-codebook-th', local_source=released)
loaded = load_model('tiny-codebook-th', device='cpu').state_dict()
assert list(loaded) == list(codebook.state_dict())
assert all(torch.equal(loaded[k], v) for k, v in codebook.state_dict().items())
"""
_PARTS['host_codec_and_harness'] = """
from viewformer_tpu_torch.data import native, tfrecord
from viewformer_tpu_torch.ops.image import decode_image, encode_image
from viewformer_tpu_torch.utils.testing import assert_gradients_same, assert_outputs_same
frame = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
assert decode_image(encode_image(frame)).shape == (16, 16, 3)
codes = rng.randint(0, 1024, 64).astype(np.int64)
payload = tfrecord.encode_example({'codes': ('int64', codes)})
assert np.array_equal(tfrecord.decode_example(payload)['codes'], codes)
packed = bytearray()
for value in codes.tolist():
    tfrecord._write_varint(packed, value)
decoded = native.decode_varints(bytes(packed))
assert decoded is None or np.array_equal(decoded, codes)
images = image_dataset(os.path.join(out, 'images'), num_sequences=4, sequence_size=4, size=8)
shard = os.path.join(images, 'colors-train-000001-of-000004.tfrecord')
assert len(list(tfrecord.read_record_spans(shard))) == 1
module = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.Tanh())
assert assert_outputs_same(module, module, (3, 8), channels_last=False)
assert assert_gradients_same(module, module, (3, 8), channels_last=False)
"""


@pytest.mark.parametrize('part', list(_PARTS))
def test_port_runs_with_jax_blocked(tmp_path, part):
    """Each part of the port runs in a process where viewformer_tpu, jax and
    flax cannot be imported, and imports none of them."""
    script = _PRELUDE.format(root=ROOT, out=str(tmp_path)) + _PARTS[part] + _EPILOGUE
    proc = subprocess.run([sys.executable, '-c', script], capture_output=True, text=True,
                          timeout=240, env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr
    assert 'ran without jax and viewformer_tpu' in proc.stdout


@pytest.mark.parametrize('alone', [False, True])
def test_chip_smoke_refuses_without_card(tmp_path, alone):
    """No CUDA device here: chip_smoke.py must fail and print no result,
    from the repo and from a directory that holds nothing else."""
    script = os.path.join(ROOT, 'chip_smoke.py')
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = dict(os.environ, PYTHONPATH='')
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
