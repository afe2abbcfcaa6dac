"""A synthetic pose-conditioned dataset, for end-to-end runs without data
(port of viewformer_tpu/data/loaders/colors.py): each sequence is a random
background colour with a circle of the inverse colour whose place follows
the camera's position, drawn deterministically from (seed, split, index)
with Pillow, which only this loader's items import."""
from functools import lru_cache, reduce

import numpy as np


class ColorsLoader:
    _custom_resize = True
    _custom_sequence_size = True

    def __init__(self, split: str, num_sequences: int = 1000, sequence_size: int = 20,
                 seed: int = 42, image_size: int = 128):
        self.split = split
        self.seed = seed
        self.sequence_size = sequence_size
        self.num_sequences = num_sequences
        self.image_size = image_size

    def __len__(self):
        return self.num_sequences

    def num_images_per_sequence(self):
        return [self.sequence_size] * self.num_sequences

    @lru_cache(maxsize=1)
    def __getitem__(self, idx):
        from PIL import Image, ImageDraw

        rng_seed = self.seed ^ idx ^ (reduce(lambda a, x: a * ord(x), self.split, 1) % 31)
        gen = np.random.RandomState(rng_seed)
        env_color = gen.randint(0, 255, (3,), dtype=np.uint8)
        positions = gen.uniform(size=(self.sequence_size, 3)).astype(np.float32)
        quat = np.tile(np.array([0, 0, 1, 0], np.float32), (self.sequence_size, 1))
        poses = np.concatenate([positions, quat], -1)
        radius = self.image_size // 6
        frames = []
        for pose in poses:
            image = Image.new('RGB', (self.image_size, self.image_size), tuple(env_color))
            draw = ImageDraw.Draw(image)
            x, y = pose[0] * self.image_size, pose[2] * self.image_size
            draw.ellipse([int(x - radius), int(y - radius), int(x + radius), int(y + radius)],
                         fill=tuple(255 - env_color))
            frames.append(np.asarray(image))
        poses[..., :3] = poses[..., :3] * 2 - 1
        return dict(cameras=poses, frames=np.stack(frames, 0))
