"""`python -m viewformer_tpu_torch serve`: the line-oriented JSON serving
protocol (port of viewformer_tpu/commands/serve.py). A long-lived process
prefills a context once and renders novel views on demand, one JSON request
a line on stdin, one JSON response a line on stdout. Images travel as file
paths (PNG or JPEG, read and written with Pillow).

Requests (batch_size is 1 for the protocol):
  {"op": "start",   "images": [path, ...], "cameras": [[7 floats], ...]}
  {"op": "observe", "image": path, "camera": [7 floats]}
  {"op": "render",  "cameras": [[7 floats], ...], "outputs": [path, ...]}
  {"op": "render",  "camera": [7 floats], "output": path}
  {"op": "localize", "image": path}      -> {"camera": [7 floats], ...}
  {"op": "status"}                       -> context, capacity, capabilities
  {"op": "stop"}

Responses: {"ok": true, "op": ..., "ms": <wall ms>, "context_frames": n}
(and "outputs": [...] for render), or {"ok": false, "error": "..."}.
Cameras are [x, y, z, qw, qx, qy, qz].
"""
import json
import sys
import time

import numpy as np


def _load_image(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


def _handle(session, request):
    op = request['op']
    if op == 'start':
        images = np.stack([_load_image(p) for p in request['images']], 0)
        session.start(images, np.asarray(request['cameras'], np.float32))
        return {}
    if op == 'observe':
        session.observe(_load_image(request['image'])[None],
                        np.asarray(request['camera'], np.float32)[None])
        return {}
    if op == 'localize':
        camera = session.localize(_load_image(request['image'])[None])
        return {'camera': [round(float(x), 6) for x in camera[0]]}
    if op == 'status':
        return {'max_frames': session.max_frames,
                'image_size': session.image_size,
                'localize': session.can_localize,
                'started': session.context_frames > 0}
    if op == 'render':
        from PIL import Image

        cameras = request.get('cameras')
        outputs = request.get('outputs')
        if cameras is None:
            cameras, outputs = [request['camera']], [request['output']]
        if len(cameras) != len(outputs):
            raise ValueError(f'{len(cameras)} cameras vs {len(outputs)} outputs')
        views = session.render(np.asarray(cameras, np.float32)[None])[0]  # [N, H, W, C]
        for view, path in zip(views, outputs):
            Image.fromarray(view).save(path)
        return {'outputs': list(outputs)}
    raise ValueError(f'unknown op {op!r}')


def serve_loop(transformer_model, codebook_model, max_frames=None, use_bfloat16=True,
               pose_multiplier=None, input_stream=None, output_stream=None, device='cuda'):
    """Run the JSONL protocol until EOF or {"op": "stop"}, on `device`."""
    from ..serve import create_session

    stdin = input_stream if input_stream is not None else sys.stdin
    stdout = output_stream if output_stream is not None else sys.stdout
    overrides = {}
    if pose_multiplier is not None:
        overrides['pose_multiplier'] = pose_multiplier
    session = create_session(transformer_model, codebook_model, max_frames=max_frames,
                             use_bfloat16=use_bfloat16, device=device, **overrides)
    print(json.dumps({'ok': True, 'op': 'ready', 'max_frames': session.max_frames,
                      'image_size': session.image_size, 'localize': session.can_localize}),
          file=stdout, flush=True)

    for line in stdin:
        line = line.strip()
        if not line:
            continue
        t0 = time.perf_counter()
        try:
            request = json.loads(line)
            if request.get('op') == 'stop':
                print(json.dumps({'ok': True, 'op': 'stop'}), file=stdout, flush=True)
                break
            extra = _handle(session, request)
            response = {'ok': True, 'op': request['op'],
                        'ms': round((time.perf_counter() - t0) * 1000, 2),
                        'context_frames': session.context_frames}
            response.update(extra)
        except Exception as exc:  # the protocol reports the error and keeps serving
            response = {'ok': False, 'error': f'{type(exc).__name__}: {exc}'}
        print(json.dumps(response), file=stdout, flush=True)
