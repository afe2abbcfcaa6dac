"""Image normalisation and resize on tensors (port of viewformer_tpu/ops/image.py)."""
import torch
import torch.nn.functional as F


def normalize_images(images):
    """uint8 [0, 255] -> f32 [-1, 1]; float images are taken as already in
    [-1, 1] and pass through."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0 * 2.0 - 1.0
    return images


def resize(images, image_size):
    """Resize [..., H, W, C] images to (image_size, image_size) with the
    reference preprocessing: nearest when upsampling, bilinear
    (align_corners=False) when downsampling; uint8 inputs go through [0, 1]
    float, are clamped and truncated back to uint8. Float inputs come back as
    float32."""
    if images.shape[-2] == image_size and images.shape[-3] == image_size:
        return images
    batch_shape = images.shape[:-3]
    x = images.reshape((-1,) + tuple(images.shape[-3:])).permute(0, 3, 1, 2)
    was_uint8 = x.dtype == torch.uint8
    x = x.float() / 255.0 if was_uint8 else x.float()
    if image_size > images.shape[-2]:
        x = F.interpolate(x, (image_size, image_size), mode='nearest')
    else:
        x = F.interpolate(x, (image_size, image_size), mode='bilinear', align_corners=False)
    if was_uint8:
        x = (x.clamp(0, 1) * 255.0).to(torch.uint8)
    x = x.permute(0, 2, 3, 1)
    return x.reshape(tuple(batch_shape) + tuple(x.shape[1:]))
