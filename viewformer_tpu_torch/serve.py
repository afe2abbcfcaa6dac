"""Serving sessions: KV-cached novel-view synthesis on one card (port of
viewformer_tpu/serve.py).

A ServingSession keeps per-layer stream-0 K/V of `batch_size` scenes on the
device (models/migt_incremental.py). `start` runs one block-causal prefill
over the context frames (kernel B1); `observe` appends a frame (one 64-token
pass over the cache, kernel B2's cache form, with its K/V written at frame
n); `render` runs N query cameras a scene as B2's query rows in one pass a
layer and decodes them; `localize` regresses an image's camera in one
64-token pass and the pose head. Each is the one-shot evaluation path's
result: the relative cameras are anchored at the first context camera at
`start`, and that transform is applied to every later camera, as one
one-shot pass over [context..., query] would.

Numpy in, numpy out. Not ported: the mesh (one card), and the JAX package's
pad of the context to a multiple of 4 frames, which only the TPU's tiles
needed.
"""
import numpy as np
import torch

from .evaluate.transformer import from_relative_cameras, normalize_cameras, to_relative_cameras
from .models import migt_incremental as inc
from .ops.image import normalize_images, upload_frames
from .utils import geometry

_IDENTITY_CAMERA = (0., 0., 0., 1., 0., 0., 0.)


def _relative_to(cameras, transform):
    """Cameras [..., 7] in the frame of `transform` [B, 7]: the one-camera
    form of to_relative_cameras."""
    while transform.dim() < cameras.dim():
        transform = transform[..., None, :]
    rot_inv = geometry.quaternion_conjugate(transform[..., 3:])
    xyz = cameras[..., :3] - transform[..., :3]
    rot_inv = rot_inv.expand(xyz.shape[:-1] + (4,))
    xyz = geometry.quaternion_rotate(xyz, rot_inv)
    quaternion = geometry.quaternion_multiply(rot_inv, cameras[..., 3:])
    return torch.cat((xyz, quaternion), -1)


class ServingSession:
    """A stateful serving session over the device the models are on.

    max_frames: the cache's capacity in context frames. Defaults to the
    training context (sequence_size - 1) and may exceed it: the positional
    embedding is per token within a frame, so nothing in the architecture
    fixes the number of context frames. The cache is in the transformer's
    dtype (bf16 on the card, where the kernels take bf16)."""

    def __init__(self, transformer, codebook, batch_size=1, max_frames=None):
        self._transformer = transformer
        self._codebook = codebook
        cfg = transformer.config
        self.batch_size = batch_size
        self.max_frames = max_frames if max_frames is not None else cfg.sequence_size - 1
        self.image_size = codebook.config.image_size
        self._relative = cfg.augment_poses == 'relative'
        self._device = transformer.wte.weight.device
        self._cache = None
        self._transform = None

    # -- inputs ---------------------------------------------------------------

    def _prepare_images(self, images, n_leading):
        """uint8 (or float in [0, 255]) [..., H, W, C] -> f32 [-1, 1] on the
        device, resized to the codebook's size."""
        images = np.asarray(images)
        expected = n_leading + 3
        if self.batch_size == 1 and images.ndim == expected - 1:
            images = images[None]
        if images.ndim != expected or images.shape[0] != self.batch_size:
            raise ValueError(
                f'expected uint8 images [{self.batch_size}, '
                f'{"T, " if n_leading == 2 else ""}H, W, C], got {images.shape}')
        return normalize_images(upload_frames(images, self.image_size, self._device))

    def _prepare_cameras(self, cameras, n_leading):
        cameras = np.asarray(cameras, np.float32)
        if self.batch_size == 1 and cameras.ndim == n_leading:
            cameras = cameras[None]
        if (cameras.ndim != n_leading + 1 or cameras.shape[-1] != 7
                or cameras.shape[0] != self.batch_size):
            raise ValueError(f'bad cameras shape {cameras.shape}')
        return torch.from_numpy(cameras).to(self._device)

    def _encode(self, images):
        """f32 images [M, H, W, C] -> codes [M, h, w]."""
        return self._codebook.encode(images)[1]

    def _query(self, cameras):
        return normalize_cameras(_relative_to(cameras, self._transform))

    def _check_started(self):
        if self._cache is None:
            raise RuntimeError('call start() first')

    # -- public API -----------------------------------------------------------

    @property
    def context_frames(self):
        return 0 if self._cache is None else self._cache.n

    @property
    def can_localize(self):
        return self._transformer.use_localization

    @torch.inference_mode()
    def start(self, images, cameras):
        """Begin a session: one batched prefill over the context frames.
        images: uint8 [B, T, H, W, C] (any H, W: resized to the codebook's
        size), cameras [B, T, 7] (xyz and a wxyz quaternion); [T, ...] when
        batch_size is 1."""
        images = self._prepare_images(images, 2)
        cameras = self._prepare_cameras(cameras, 2)
        B, T = cameras.shape[:2]
        if not 1 <= T <= self.max_frames:
            raise ValueError(f'context size {T} not in [1, {self.max_frames}]')
        if self._relative:
            cameras, transform = to_relative_cameras(cameras)
            transform = transform[:, 0]
        else:
            transform = torch.tensor(_IDENTITY_CAMERA, device=self._device).expand(B, 7)
        codes = self._encode(images.reshape((B * T,) + tuple(images.shape[2:])))
        codes = codes.reshape((B, T) + tuple(codes.shape[1:]))
        self._cache = inc.prefill_cache(self._transformer, codes, normalize_cameras(cameras),
                                        max_frames=self.max_frames)
        self._transform = transform

    @torch.inference_mode()
    def observe(self, image, camera):
        """Append one observed frame to the context: image uint8
        [B, H, W, C], camera [B, 7]."""
        self._check_started()
        if self._cache.n >= self.max_frames:
            raise RuntimeError(f'context full ({self.max_frames} frames); raise max_frames')
        image = self._prepare_images(image, 1)
        camera = self._prepare_cameras(camera, 1)
        self._cache = inc.extend_cache(self._transformer, self._cache, self._encode(image),
                                       self._query(camera))

    def _logits(self, cameras):
        """Query cameras [B, N, 7] on the device -> logits [B, N, h, w, V]."""
        return inc.generate_frame(self._transformer, self._cache, self._query(cameras))

    @torch.inference_mode()
    def render(self, cameras, return_tokens=False):
        """Render novel views for query cameras [B, 7] or [B, N, 7] -> uint8
        [B, H, W, C] or [B, N, H, W, C] (with return_tokens, also the codes).
        The N views of a scene share its cache: one B2 launch a layer."""
        self._check_started()
        cameras = np.asarray(cameras, np.float32)
        squeeze = cameras.ndim == 2 or (self.batch_size == 1 and cameras.ndim == 1)
        cameras = self._prepare_cameras(cameras[..., None, :] if squeeze else cameras, 2)
        codes = self._logits(cameras).argmax(-1)
        B, N = codes.shape[:2]
        images = self._codebook.decode_code(codes.reshape((B * N,) + tuple(codes.shape[2:])))
        images = ((images.clamp(-1, 1) / 2 + 0.5) * 255.0 + 0.5).to(torch.uint8)
        images = images.reshape((B, N) + tuple(images.shape[1:])).cpu().numpy()
        codes = codes.cpu().numpy()
        if squeeze:
            images, codes = images[:, 0], codes[:, 0]
        return (images, codes) if return_tokens else images

    @torch.inference_mode()
    def localize(self, image):
        """The world-frame camera [B, 7] of an observed image uint8
        [B, H, W, C], against the cached context: one 64-token pass with the
        localization token, the pose head, the mean of the per-token
        predictions, mapped back through the session's transform."""
        self._check_started()
        if not self.can_localize:
            raise RuntimeError('model trained without localization (localization_weight 0)')
        image = self._prepare_images(image, 1)
        pred = inc.localize_frame(self._transformer, self._cache, self._encode(image))
        camera = self._transformer.reduce_cameras(pred)  # [B, 7]
        if self._relative:
            camera = from_relative_cameras(camera, self._transform)
        return camera.cpu().numpy()

    @torch.inference_mode()
    def render_logits(self, cameras):
        """Diagnostic: the query frames' f32 logits [B, N, h, w, vocab] for
        cameras [B, N, 7]."""
        self._check_started()
        return self._logits(self._prepare_cameras(cameras, 2)).cpu().numpy()


def create_session(transformer_checkpoint, codebook_checkpoint, batch_size=1, max_frames=None,
                   use_bfloat16=True, device='cuda', **config_overrides):
    """Load two job dirs of the port and build a ServingSession on `device`
    (the card unless the caller asks for the CPU), with bf16 weights and
    cache by default; the f32 islands stay f32 (models.load_model)."""
    from .models import load_model

    dtype = torch.bfloat16 if use_bfloat16 else torch.float32
    transformer = load_model(transformer_checkpoint, dtype, device, **config_overrides)
    codebook = load_model(codebook_checkpoint, dtype, device)
    return ServingSession(transformer, codebook, batch_size=batch_size, max_frames=max_frames)
