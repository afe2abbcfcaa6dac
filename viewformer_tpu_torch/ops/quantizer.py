"""The EMA vector quantizer (port of init_quantizer_state, nearest_codes,
embed_code and quantize_ema in viewformer_tpu/ops/quantizer.py). The
codebook is [D, N], column-major like the reference; its state lives in the
buffers of models.vqgan.Quantizer, which quantize_ema updates in place."""
import math

import torch


def init_quantizer_state(embedding_dim, num_embeddings, generator=None):
    """{embeddings [D, N] uniform in +-sqrt(3) (the reference's init),
    ema_cluster_size_hidden [N], ema_dw_hidden [D, N] (zeros), counter (int32
    0)}, drawn from `generator`."""
    limit = math.sqrt(3.0)
    return {
        'embeddings': torch.rand(embedding_dim, num_embeddings, generator=generator)
        * 2 * limit - limit,
        'ema_cluster_size_hidden': torch.zeros(num_embeddings),
        'ema_dw_hidden': torch.zeros(embedding_dim, num_embeddings),
        'counter': torch.zeros((), dtype=torch.int32)}


def nearest_codes(embeddings, inputs):
    """Nearest-codebook-entry indices for [..., D] inputs against [D, N].

    argmax of 2 x.W - |w|^2 (the |x|^2 term is constant per input). The
    product runs in full f32: codes near a Voronoi boundary must not flip, so
    the caller keeps TF32 off on the card (viewformer_tpu_torch sets
    torch.backends.cuda.matmul.allow_tf32 = False)."""
    flat = inputs.reshape(-1, embeddings.shape[0]).float()
    emb = embeddings.float()
    scores = 2.0 * (flat @ emb) - (emb ** 2).sum(0)[None, :]
    return scores.argmax(1).reshape(inputs.shape[:-1])


def embed_code(embeddings, indices):
    """Indices [...] -> codebook vectors [..., D]."""
    return embeddings.t()[indices]


def quantize_ema(state, inputs, *, training, decay=0.99, epsilon=1e-5):
    """EMA vector quantization of [..., D] f32 inputs against `state` (a
    models.vqgan.Quantizer). Returns (quantized [..., D] with the
    straight-through gradient, e_latent_loss, indices [...]).

    quantized and the loss use the embeddings as they were before this call.
    With training=True the EMA statistics of this batch then update the
    state's buffers in place, without gradient: one-hot counts and
    inputs^T @ one-hot in f32, hidden EMAs moved by (1 - decay), the counter
    + 1, bias correction 1 - decay^counter, Laplace-smoothed cluster sizes,
    embeddings = ema_dw / smoothed sizes. training=False leaves the state
    as it is."""
    embeddings = state.embeddings
    embedding_dim, num_embeddings = embeddings.shape
    indices = nearest_codes(embeddings, inputs)
    quantized = embed_code(embeddings, indices).to(inputs.dtype)
    e_latent_loss = ((quantized.float().detach() - inputs.float()) ** 2).mean()

    if training:
        with torch.no_grad():
            flat = inputs.detach().reshape(-1, embedding_dim).float()
            onehot = torch.nn.functional.one_hot(indices.reshape(-1), num_embeddings).float()
            embed_onehot_sum = onehot.sum(0)
            embed_sum = flat.t() @ onehot
            cluster = state.ema_cluster_size_hidden
            dw = state.ema_dw_hidden
            cluster.add_((embed_onehot_sum - cluster) * (1 - decay))
            dw.add_((embed_sum - dw) * (1 - decay))
            state.counter.add_(1)
            correction = 1.0 - decay ** state.counter.float()
            ema_cluster_size = cluster / correction
            ema_dw = dw / correction
            n = ema_cluster_size.sum()
            smoothed = (ema_cluster_size + epsilon) / (n + num_embeddings * epsilon) * n
            # `quantized` is an index copy: overwriting the embeddings leaves it be
            embeddings.copy_(ema_dw / smoothed)

    # straight-through estimator
    quantized = inputs + (quantized - inputs).detach()
    return quantized, e_latent_loss, indices
