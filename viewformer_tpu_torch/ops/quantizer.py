"""Codebook lookup (port of nearest_codes / embed_code in
viewformer_tpu/ops/quantizer.py). The codebook is [D, N], column-major like
the reference."""


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
