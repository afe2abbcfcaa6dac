"""model info: the parameter count of a checkpoint's model (port of
viewformer_tpu/commands/model_info.py), tensor by tensor and by the JAX
package's collections: 'params', and 'quantizer' for the VQ-GAN's codebook
state. Each port parameter and buffer is listed under its JAX path
(utils/convert.jax_leaves), so the totals are the JAX package's."""


def model_info(checkpoint, device='cuda'):
    """Print the model of `checkpoint` (a path or an installed released
    name, as load_model takes) and a row per tensor (JAX path, port shape,
    size), a total per collection and the grand total, which it returns.
    Loads the model on `device`: the card unless the caller asks for the
    CPU."""
    from ..models import load_model
    from ..utils.convert import jax_leaves

    model = load_model(checkpoint, device=device)
    print(f'model: {model.config.model} ({type(model).__name__})')
    collections = {}
    for _, path, _, tensor in jax_leaves(model):
        collections.setdefault(path[0], []).append((path[1:], tuple(tensor.shape),
                                                    tensor.numel()))
    grand_total = 0
    for collection in sorted(collections, key=('params', 'quantizer').index):
        rows = sorted(collections[collection])
        total = sum(size for _, _, size in rows)
        grand_total += total
        print(f'\n[{collection}] {total:,} parameters')
        for path, shape, size in rows:
            print(f'  {"/".join(path):<60} {str(shape):<22} {size:>12,}')
    print(f'\ntotal: {grand_total:,} parameters')
    return grand_total
