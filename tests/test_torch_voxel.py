"""chipmunk_torch.ops.voxel against chipmunk_tpu.ops.voxel: the same
arrays, element for element, including the tails when the grid does not
divide by the voxel shape (540p: 34 % 4 and 60 % 8), local_voxels 0 and 1,
and the 1-D window."""
import numpy as np
import pytest

from chipmunk_tpu.ops import voxel as jvox
from chipmunk_torch.ops import voxel

GRIDS = [(8, 4, 8), (5, 8, 15), (33, 34, 60), (3, 6, 10)]


@pytest.mark.parametrize('grid', GRIDS)
def test_voxel_order_matches_reference(grid):
    p = voxel.voxel_order(*grid)
    np.testing.assert_array_equal(p, jvox.voxel_order(*grid))
    assert p.dtype == np.int32 and sorted(p) == list(range(np.prod(grid)))
    np.testing.assert_array_equal(voxel.inverse_voxel_order(*grid),
                                  jvox.inverse_voxel_order(*grid))
    np.testing.assert_array_equal(
        voxel.voxel_order(*grid, (2, 2, 4)), jvox.voxel_order(*grid, (2, 2, 4)))


@pytest.mark.parametrize('grid,local', [((4, 3, 5), (1, 1, 1)),
                                        ((4, 3, 5), (3, 3, 3)),
                                        ((2, 2, 7), (2, 1, 4)),
                                        ((3, 3, 3), (0, 1, 1))])
def test_local_voxel_indices_match_reference(grid, local):
    np.testing.assert_array_equal(
        voxel.get_local_voxel_indices(grid, local),
        jvox.get_local_voxel_indices(grid, local))


@pytest.mark.parametrize('vid,txt,lv,kw', [
    ((8, 4, 8), 128, 0, {}),
    ((8, 4, 8), 72, 1, {}),
    ((5, 8, 15), 256, 1, {}),
    ((9, 8, 24), 100, 3, {'full_tail_to_attn': True,
                          'full_tail_from_attn': True}),
    ((8, 8, 16), 72, 1, {'rk': 0.1}),
    ((33, 34, 60), 256, 0, {}),          # HunyuanVideo 540p
])
def test_static_mask_with_text_matches_reference(vid, txt, lv, kw):
    a = voxel.get_local_indices_with_text(vid, txt, local_shape=(lv,) * 3,
                                          **kw)
    b = jvox.get_local_indices_with_text(vid, txt, local_shape=(lv,) * 3,
                                         **kw)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('frac', [0.0, 0.1, 0.37])
def test_local_1d_window_matches_reference(frac):
    np.testing.assert_array_equal(
        voxel.local_1d_window_mask(1000, 1384, frac),
        jvox.local_1d_window_mask(1000, 1384, frac))


@pytest.mark.parametrize('grid,vs', [((8, 4, 8), (4, 4, 8)),
                                     ((5, 6, 9), (4, 4, 8)),
                                     ((3, 6, 10), (2, 2, 4))])
def test_voxel_reorders_of_tensors_match_reference(grid, vs):
    """voxel_chunk_no_padding and voxel_tokens (and their inverses) on
    torch tensors against the reference's on the same arrays."""
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(sum(grid))
    x = rng.standard_normal((2, 3, *grid, 4)).astype(np.float32)
    got = voxel.voxel_chunk_no_padding(torch.from_numpy(x), vs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jvox.voxel_chunk_no_padding(jnp.asarray(x), vs)))
    np.testing.assert_array_equal(
        voxel.reverse_voxel_chunk_no_padding(got, x.shape, vs).numpy(), x)
    tok = rng.standard_normal((2, int(np.prod(grid)), 5)).astype(np.float32)
    got = voxel.voxel_tokens(torch.from_numpy(tok), grid, 1, vs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jvox.voxel_tokens(jnp.asarray(tok), grid, 1, vs)))
    np.testing.assert_array_equal(
        voxel.unvoxel_tokens(got, grid, 1, vs).numpy(),
        np.asarray(jvox.unvoxel_tokens(jnp.asarray(np.asarray(got)), grid,
                                       1, vs)))
    np.testing.assert_array_equal(
        voxel.unvoxel_tokens(got, grid, 1, vs).numpy(), tok)
