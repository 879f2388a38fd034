"""The operation and byte counts equal hand arithmetic."""

from benchmark import counts

W, L, B, P = 256, 128, 16, 64 ** 3
CRITIC = {"feature_counts": [128, 64, 32, 1], "final_features": 256, "head_features": 128, "kernel": 4}


def test_point_and_shape_terms():
    per_point = (2 * 3 * 256            # layer 1, the point's part: 3 -> 256
                 + 3 * 2 * 256 * 256    # layers 2-4: 256 -> 256
                 + 2 * 259 * 256        # layer 5: hidden and point parts, 259 -> 256
                 + 2 * 2 * 256 * 256    # layers 6-7
                 + 2 * 256)             # layer 8: 256 -> 1
    assert per_point == 790016 == counts.sdf_point_flops(W)
    assert counts.sdf_shape_flops(W, L) == 2 * 2 * 128 * 256   # layers 1 and 5, latent part, once a shape


def test_grid_forward_at_16_x_64_cubed():
    flops, nbytes = counts.grid_forward(B, P, W, L)
    assert flops == 16 * 262144 * 790016 + 16 * 131072
    assert abs(flops - 3.3136e12) < 1e9                      # about 3.3 TFLOP
    params = 131 * 256 + 256 + 3 * (256 * 256 + 256) + 387 * 256 + 256 + 2 * (256 * 256 + 256) + 257
    assert params == counts.sdf_param_count(W, L)
    assert nbytes == 4 * (3 * P + 16 * 128 + params + 16 * P)
    bwd, _ = counts.grid_backward(B, P, W, L)
    assert bwd == 2 * flops                                   # backward: twice the forward, no recompute


def test_critic_at_64_cubed():
    per_volume = (2 * 32 ** 3 * 32 * 1 * 64      # entry conv 1 -> 32 channels, 64^3 -> 32^3, 4^3 taps
                  + 2 * 16 ** 3 * 64 * 32 * 64    # 32 -> 64, 32^3 -> 16^3
                  + 2 * 8 ** 3 * 128 * 64 * 64    # 64 -> 128, 16^3 -> 8^3
                  + 2 * 4 ** 3 * 256 * 128 * 64   # 128 -> 256, 8^3 -> 4^3
                  + 2 * (16384 * 128 + 128))      # the head: 4^3 x 256 -> 128 -> 1
    assert counts.critic_forward_flops(CRITIC, 64, 3, 16) == 16 * per_volume
    assert counts.CRITIC_PASSES_D_STEP == 12 and counts.CRITIC_PASSES_G_STEP == 2


def test_least_seconds_takes_the_larger_bound():
    p = counts.peaks()
    assert counts.least_seconds(989e12, 0) == 989e12 / p["bf16_dense_flops"] == 1.0
    assert counts.least_seconds(0, 3.35e12) == 1.0
