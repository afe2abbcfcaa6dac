"""Image normalisation and resize on tensors, and the image codecs (port of
viewformer_tpu/ops/image.py). The JAX package's native libjpeg decoder
(native/vfimage.cc) is not ported: the codecs use Pillow, imported where an
image is encoded or decoded."""
import io

import numpy as np
import torch
import torch.nn.functional as F


def normalize_images(images):
    """uint8 [0, 255] -> f32 [-1, 1]; float images are taken as already in
    [-1, 1] and pass through."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0 * 2.0 - 1.0
    return images


def resize(images, image_size, method=None):
    """Resize [..., H, W, C] images to (image_size, image_size) with the
    reference preprocessing. method: None (nearest when upsampling, bilinear
    when downsampling), 'nearest' or 'bilinear' (align_corners=False). uint8
    inputs go through [0, 1] float, are clamped and truncated back to uint8.
    Float inputs come back as float32."""
    if images.shape[-2] == image_size and images.shape[-3] == image_size:
        return images
    if method is None:
        method = 'nearest' if image_size > images.shape[-2] else 'bilinear'
    elif method not in ('nearest', 'bilinear'):
        raise ValueError(f"method must be 'nearest' or 'bilinear', got {method!r}")
    batch_shape = images.shape[:-3]
    x = images.reshape((-1,) + tuple(images.shape[-3:])).permute(0, 3, 1, 2)
    was_uint8 = x.dtype == torch.uint8
    x = x.float() / 255.0 if was_uint8 else x.float()
    if method == 'nearest':
        x = F.interpolate(x, (image_size, image_size), mode='nearest')
    else:
        x = F.interpolate(x, (image_size, image_size), mode='bilinear', align_corners=False)
    if was_uint8:
        x = (x.clamp(0, 1) * 255.0).to(torch.uint8)
    x = x.permute(0, 2, 3, 1)
    return x.reshape(tuple(batch_shape) + tuple(x.shape[1:]))


def ensure_wire_images(images):
    """Host frames for an upload: uint8 numpy passes as it is (the device
    maps it to [-1, 1], normalize_images); float frames, taken as [0, 255],
    are mapped to f32 [-1, 1] here."""
    images = np.asarray(images)
    if images.dtype == np.uint8:
        return images
    return images.astype(np.float32) / 255.0 * 2.0 - 1.0


def upload_frames(images, image_size, device):
    """uint8 (or float in [0, 255]) numpy frames [..., H, W, C] -> a tensor
    on `device`, resized to image_size: uint8 as it is (normalize_images
    maps it to [-1, 1] there), float mapped to [-1, 1]."""
    # a copy when read-only (an image Pillow decoded): torch takes writable arrays
    images = np.require(np.asarray(images), requirements=('C', 'W'))
    frames = resize(torch.from_numpy(images).to(device), image_size)
    return frames if frames.dtype == torch.uint8 else frames.float() / 255.0 * 2.0 - 1.0


def encode_image(image):
    """uint8 [H, W, 3|4] -> JPEG (RGB, quality 95) or PNG (RGBA) bytes, the
    reference's shard format."""
    from PIL import Image

    image = np.asarray(image)
    if image.shape[-1] == 4:
        pil, fmt, kwargs = Image.fromarray(image, 'RGBA'), 'PNG', {}
    else:
        pil, fmt, kwargs = Image.fromarray(image, 'RGB'), 'JPEG', {'quality': 95}
    buf = io.BytesIO()
    pil.save(buf, fmt, **kwargs)
    return buf.getvalue()


def decode_image(data):
    """JPEG or PNG bytes -> uint8 numpy [H, W, C] (RGB, or RGBA as stored),
    with Pillow, imported here: only image files need it."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as pil:
        if pil.mode not in ('RGB', 'RGBA'):
            pil = pil.convert('RGB')
        return np.asarray(pil)
