"""The FLOP and byte counts that give each attention kernel's bound
(viewformer_tpu_torch.ops.attention_cost), at the main paths' shapes."""
import pytest

from viewformer_tpu_torch.ops import attention_cost as cost

# the counts of each kernel at the main paths' shapes: (FLOPs, bytes, bound ms, bound by)
ANCHORS = {
    'B1 serving': (cost.block_causal_cost(384, 19, 64, 64), 7.65e10, 239e6, 0.077, 'operations'),
    'B1 training': (cost.block_causal_cost(768, 20, 64, 64, lse=True), 1.69e11, 503e6, 0.171,
                    'operations'),
    'B2 one-shot': (cost.branch_cost(1536, 20, 768, 20, 64, 64, 0, 20, lse=True), 3.38e11,
                    1.26e9, 0.376, 'bytes'),
    'B2 cache form': (cost.branch_cost(384, 1, 384, 20, 64, 64, 19, 19), 8.05e9, 132e6, 0.039,
                      'bytes'),
    'B3': (cost.block_causal_cost(768, 20, 64, 64, backward=True), 4.23e11, 1.01e9, 0.43,
           'operations'),
}


@pytest.mark.parametrize('case', sorted(ANCHORS))
def test_kernel_cost_anchors(case):
    (flops, nbytes), want_flops, want_bytes, want_ms, want_by = ANCHORS[case]
    ms, by = cost.bound_ms(flops, nbytes)
    assert flops == pytest.approx(want_flops, rel=5e-3)
    assert nbytes == pytest.approx(want_bytes, rel=1.5e-2)
    assert ms == pytest.approx(want_ms, rel=1.5e-2)
    assert by == want_by


def test_kernel_cost_counts_only_seen_frames():
    """A frame no query sees is neither read nor computed: B2 with n_old = 3
    of 20 stream-0 frames reads 3 frames of K0/V0 and does 4 pairs a query
    frame; its backward still writes dk0/dv0 whole."""
    flops, nbytes = cost.branch_cost(2, 1, 2, 20, 64, 64, 3, 3)
    assert flops == 2 * 4 * 2 * 2 * 64 * 64 * 64
    assert nbytes == 4 * 2 * 64 * 64 * 2 + 2 * 2 * 3 * 64 * 64 * 2
    flops_b, nbytes_b = cost.branch_cost(2, 1, 2, 20, 64, 64, 3, 3, backward=True)
    assert flops_b == flops * 5 // 2
    assert nbytes_b == 8 * 2 * 64 * 64 * 2 + 2 * 2 * 3 * 64 * 64 * 2 + 2 * 64 * 4 + \
        2 * 2 * 20 * 64 * 64 * 2
