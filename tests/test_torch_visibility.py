"""The fused visibility wrapper (wass_tpu_torch.post.visibility_kernels.
visibility_batch) and the grid's fixed-order segment sums on the CPU.

On CPU tensors the wrapper runs its plain version, which the card's fused
kernel matches bit for bit (tests/test_torch_kernels_cuda.py).  It is held
against the JAX program wass_tpu/post/geometry.py:_visibility_device_batch
under jax.disable_jit() (op by op, as the port runs it): the occlusion
equal, the incidence NaN at the same cells and within 3e-5 degrees
(torch's and XLA's arccos differ by up to 2 float32 ulps, the product by
180/pi adds one: 4 ulps at 64-128 degrees).  The segment sums that the
card's outlier votes take (wass_tpu_torch.grid.outliers.segment_sums) run
here on CPU tensors too: within 1e-6 of float64 sums, exact on
integer-valued data, and their votes equal to the JAX package's."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wass_tpu.grid.outliers as jo
from wass_tpu.post import geometry as jg

import wass_tpu_torch
import wass_tpu_torch.grid.outliers as to
from wass_tpu_torch.post import visibility_kernels as vk

from test_torch_grid import _spiky_cloud


def _slab(B, H, W, seed, hole, layout="xy", cam=None):
    """Wave-like frames in cell units, the grids and a camera (numpy); the
    cube's (count, X, Y) layout has XX varying along axis 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    Z = np.stack([3 * np.sin(0.3 * xx + 0.2 * yy + b) + rng.uniform(0, 1, (H, W)) for b in range(B)])
    Z = Z.astype(np.float32)
    if hole:
        Z[0, H // 3:H // 3 + 3, W // 2:W // 2 + 4] = np.nan
    if layout == "cube":
        xx, yy = yy, xx
    cam = np.array([-0.3 * W, 1.4 * H, 12.0] if cam is None else cam, np.float32)
    return Z, cam, np.ascontiguousarray(xx), np.ascontiguousarray(yy), 2 * max(H, W)


CASES = {
    "wave": (4, 40, 48, 0, False),
    "hole": (3, 37, 53, 1, True),
    "thin": (2, 29, 7, 2, False),
    "grazing": (3, 32, 64, 3, False, "xy", [-200.0, 16.0, 4.0]),
    "camera over the grid": (3, 32, 40, 4, True, "xy", [20.0, 16.0, 6.0]),
    "the command's layout": (3, 36, 44, 5, True, "cube"),
}


@pytest.mark.parametrize("case", CASES)
def test_visibility_batch_matches_jax(case):
    Z, cam, XX, YY, steps = _slab(*CASES[case])
    with jax.disable_jit():
        oj, ij = jg._visibility_device_batch(jnp.asarray(Z), jnp.asarray(cam), jnp.asarray(XX), jnp.asarray(YY),
                                             steps)
    oj, ij = np.asarray(oj), np.asarray(ij)
    op, ip = vk.visibility_batch(*(torch.as_tensor(a) for a in (Z, cam, XX, YY)), steps)
    assert op.dtype == torch.bool and ip.dtype == torch.float32 and op.shape == ip.shape == Z.shape
    op, ip = op.numpy(), ip.numpy()
    np.testing.assert_array_equal(op, oj)
    assert np.array_equal(np.isnan(ip), np.isnan(ij))
    if case == "the command's layout":  # XX[0, 1] - XX[0, 0] = 0: every slope, and so every incidence, is NaN
        assert np.isnan(ip).all() and np.isnan(ij).all()
    else:
        assert np.nanmax(np.abs(ip - ij)) <= 3e-5
        assert (op > (ip >= 88)).any()  # the march occludes cells that are not grazing


def test_visibility_batch_plain_is_the_op_by_op_program():
    """The plain version is the march over ray_steps(view_rays) with the
    incidence of the normals, op by op."""
    Z, cam, XX, YY, steps = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in _slab(*CASES["hole"]))
    occ, inc = vk.visibility_batch_plain(Z, cam, XX, YY, steps)
    rays = vk.view_rays(Z, cam, XX, YY)
    march = vk.march_plain(Z, vk.ray_steps(rays), Z.amax(dim=(1, 2)), steps)
    assert torch.equal(occ, (march != 0) | (inc >= 88.0))
    assert not march[0].any() and march[1:].any()  # frame 0's max is NaN: none of its rays marches
    sx = vk._grad(Z, 2) / (XX[0, 1] - XX[0, 0])
    sy = vk._grad(Z, 1) / (YY[1, 0] - YY[0, 0])
    n = torch.stack([sx, sy, -torch.ones_like(Z)], -1)
    cos = ((-n / vk._norm3(n)) * rays).sum(-1).clamp(-1, 1)
    np.testing.assert_allclose(inc.numpy(), (torch.arccos(cos) * (180 / math.pi)).numpy(), atol=1e-4)


def test_march_plain_counts_steps():
    """The plain march's step count: each ray's steps until it stops."""
    Z = torch.zeros((1, 3, 6))
    Z[0, 1, 4] = 5.0
    d = torch.tensor([[1.0, 0.0, 0.5]]).repeat(18, 1)
    occ, steps = vk.march_plain(Z, d, Z.amax(dim=(1, 2)), 20, count_steps=True)
    # Row 1: x = 0..3 step to the peak at x = 4 (4, 3, 2, 1 steps), x = 4
    # and 5 leave the grid or climb over the max (1 step each); rows 0 and
    # 2 run off the grid (6 - x steps: 21 a row).
    assert occ[0, 1].tolist() == [1, 1, 1, 1, 0, 0] and not occ[0, 0].any()
    assert steps == (4 + 3 + 2 + 1 + 1 + 1) + 2 * 21


def test_visibility_batch_checks_its_arguments():
    Z, cam, XX, YY, steps = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in _slab(2, 8, 10, 0, False))
    wass_tpu_torch.reset_launch_counts()
    vk.visibility_batch(Z, cam, XX, YY, steps)
    assert wass_tpu_torch.launch_counts()["visibility_batch"] == 0  # the plain version launches nothing
    bad = [
        (Z.double(), cam, XX, YY),  # dtype
        (Z, cam.double(), XX, YY),
        (Z[0], cam, XX, YY),  # shapes
        (Z, cam[:2], XX, YY),
        (Z, cam, XX[:-1], YY),
        (Z, cam, XX, YY.T.contiguous()),
        (Z[:, :1].contiguous(), cam, XX[:1].contiguous(), YY[:1].contiguous()),  # H < 2
        (Z[:, :, :1].contiguous(), cam, XX[:, :1].contiguous(), YY[:, :1].contiguous()),  # W < 2
        (Z.transpose(1, 2).contiguous().transpose(1, 2), cam, XX, YY),  # not contiguous
        (Z, cam, XX.T.contiguous().T, YY),
        (Z, cam.to("meta"), XX, YY),  # mixed devices
    ]
    for args in bad:
        with pytest.raises(ValueError):
            vk.visibility_batch(*args, steps)


@pytest.mark.parametrize("n, cells, crowd", [(100000, 225, 7), (5000, 9, 4), (300, 225, 0), (1, 225, 3), (0, 225, 0)])
def test_segment_sums_fixed_order(n, cells, crowd):
    """The card's segment sums on CPU tensors: within 1e-6 of float64 sums
    (relative to the sums of |v|), exact on small integers, 0 for empty
    cells, the same bits on a second plan."""
    rng = np.random.default_rng(n)
    cell = torch.as_tensor(rng.integers(0, cells, n))
    cell[: n // 3] = crowd  # one crowded cell: more than one level of rows
    v = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32))
    plan = to.segment_plan(cell, 225)
    got = to.segment_sums(v, plan)
    assert got.shape == (225, 3) and got.dtype == torch.float32
    want = torch.zeros(225, 3, dtype=torch.float64).index_add_(0, cell, v.double())
    scale = torch.zeros(225, 3, dtype=torch.float64).index_add_(0, cell, v.double().abs())
    assert ((got.double() - want).abs() <= 1e-6 * scale + 1e-30).all()
    ints = torch.as_tensor(rng.integers(-50, 50, (n, 2)).astype(np.float32))
    exact = torch.zeros(225, 2, dtype=torch.float64).index_add_(0, cell, ints.double())
    assert torch.equal(to.segment_sums(ints, plan).double(), exact)
    assert torch.equal(to.segment_sums(v, to.segment_plan(cell, 225)), got)
    if n >= 100000:
        assert len(plan[1]) >= 2


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fixed_order_votes_match_jax(seed):
    """The votes with the card's fixed-order sums, on the CPU: the JAX
    package's on the spiky clouds of test_outlier_votes_match_jax (the
    sums differ from index_add_'s in their last bits only)."""
    mesh, bad = _spiky_cloud(seed)
    pts = np.ascontiguousarray(mesh.T, np.float32)
    want = np.asarray(jo._vote_device(jnp.asarray(pts), jnp.float32(0.2)))
    got = to._vote_device(torch.as_tensor(pts), 0.2, fixed_order=True).numpy()
    np.testing.assert_array_equal(got, want)
