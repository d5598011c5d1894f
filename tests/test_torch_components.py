"""Port parity: connected-component labels (wass_tpu_torch/ops/components.py,
the K7 wrapper on CPU tensors) against the JAX scan path and the Pallas
kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.ops import components as jcomp
from wass_tpu.ops.components_pallas import label_components_pallas
from wass_tpu_torch.ops import components as tcomp
from wass_tpu_torch.ops import components_kernels


def _speckle():
    return np.random.default_rng(42).random((64, 128)) > 0.6


def _snake():
    H, W = 40, 96
    mask = np.zeros((H, W), bool)
    for r in range(0, H, 4):
        mask[r, :] = True
        if (r // 4) % 2 == 0:
            mask[r : r + 4, W - 1] = True
        else:
            mask[r : r + 4, 0] = True
    return mask


def _zgap_scene():
    """A wavy z field with cliffs and holes, its valid mask, and the edge
    gates |dz| < 0.3 of the z-gap filter."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:48, 0:80]
    z = (10 + 0.05 * yy + 0.2 * np.sin(xx / 6.0)).astype(np.float32)
    z[:, 50:] += 3.0  # cliff
    z[30:, 10:20] -= 2.0
    valid = rng.random(z.shape) > 0.15
    return z, valid


@pytest.mark.parametrize("make_mask", [_speckle, _snake], ids=["speckle", "snake"])
def test_labels_bit_equal(make_mask):
    mask = make_mask()
    ref = np.asarray(jcomp.label_components(jnp.asarray(mask), max_iters=64))  # converged
    pal = np.asarray(label_components_pallas(jnp.asarray(mask), max_iters=12, interpret=True))
    out = tcomp.label_components(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pal)


def test_labels_zgap_gated():
    z, valid = _zgap_scene()
    eh, ev = np.abs(z[:, :-1] - z[:, 1:]) < 0.3, np.abs(z[:-1] - z[1:]) < 0.3
    ref = np.asarray(jcomp.label_components(jnp.asarray(valid), jnp.asarray(eh), jnp.asarray(ev)))
    pal = np.asarray(label_components_pallas(jnp.asarray(valid), jnp.asarray(eh), jnp.asarray(ev), interpret=True))
    out = tcomp.label_components(torch.from_numpy(valid), torch.from_numpy(eh), torch.from_numpy(ev)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pal)


def test_zgap_component_mask_equal():
    z, valid = _zgap_scene()
    ref = np.asarray(jcomp.zgap_component_mask(jnp.asarray(z), jnp.asarray(valid), jnp.float32(0.3)))
    out = tcomp.zgap_component_mask(torch.from_numpy(z), torch.from_numpy(valid), torch.tensor(0.3)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.any()


def test_biggest_component_mask_equal():
    """Against the converged reference: on this near-percolation mask the
    scan path's 12 rounds stop short, the port's 2 x 12 rounds do not."""
    mask = np.random.default_rng(1).random((48, 64)) > 0.55
    ref = np.asarray(jcomp.biggest_component_mask(jnp.asarray(mask), max_iters=64))
    np.testing.assert_array_equal(tcomp.biggest_component_mask(torch.from_numpy(mask)).numpy(), ref)


@pytest.mark.parametrize("shape", [(64, 64), (1100, 1000)], ids=["full-vote", "stride-4-vote"])
def test_modal_label_matches_jax(shape):
    """Largest component's label, ties to the smallest; above 2^20 pixels the
    vote runs on the stride-4 sample (labels built directly, no propagation)."""
    rng = np.random.default_rng(9)
    labels = rng.choice(np.array([3, 7, 11, 2**31 - 1], np.int32), size=shape, p=[0.3, 0.3, 0.2, 0.2])
    labels[::4, ::4] = 11  # the sample sees 11 most, the full frame does not
    valid = labels != 2**31 - 1
    ref = int(jcomp._modal_label(jnp.asarray(labels), jnp.asarray(valid)))
    assert tcomp._modal_label(torch.from_numpy(labels), torch.from_numpy(valid)) == ref


def test_propagate_wrapper_runs_plain_on_cpu():
    mask = torch.from_numpy(_speckle())
    H, W = mask.shape
    init = torch.where(mask, torch.arange(H * W, dtype=torch.int32).reshape(H, W), tcomp.INT32_MAX)
    conn = torch.zeros((H, W), dtype=torch.uint8)
    conn[1:] = (mask[1:] & mask[:-1]).to(torch.uint8)
    before = dict(components_kernels.LAUNCHES)
    out = components_kernels.propagate_labels(init, conn, torch.zeros_like(conn), 3)
    assert torch.equal(out, components_kernels.propagate_labels_plain(init, conn, torch.zeros_like(conn), 3))
    assert components_kernels.LAUNCHES == before
