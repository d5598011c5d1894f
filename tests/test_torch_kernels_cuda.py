"""The CUDA kernels against their plain versions on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc and skip without them.
Run them on the GPU machine, which has no jax for the shared conftest, with
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py -q
(chip_smoke.py checks the same kernels at the full 3 MP shapes)."""

import pytest
import torch

import wass_tpu_torch
from wass_tpu_torch.ops import components_kernels as ck
from wass_tpu_torch.stereo import sgm_kernels as sk
from wass_tpu_torch.stereo.cost import census_cost_volume, census_transform
from wass_tpu_torch.stereo.sgm import sgm_wta_fused_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _census_pair(dev, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    a, b = (torch.rand((h, w), generator=g) * 255 for _ in range(2))
    return census_transform(a.to(dev), (7, 9), 0.8), census_transform(b.to(dev), (7, 9), 0.8)


SHAPES = [(48, 64, 32, 1), (37, 101, 36, 3), (101, 77, 52, 1), (61, 70, 96, 0)]


@pytest.mark.parametrize("h,w,d,min_disp", SHAPES)
def test_census_cost_kernel(dev, h, w, d, min_disp):
    cb, cm = _census_pair(dev, h, w, h)
    assert torch.equal(sk.census_cost_volume(cb, cm, d, min_disp), census_cost_volume(cb, cm, d, min_disp))


@pytest.mark.parametrize("h,w,d,min_disp", SHAPES)
@pytest.mark.parametrize("directions,uniq", [(5, 1), (8, 1), (8, 5)])
def test_sgm_wta_fused_kernel(dev, h, w, d, min_disp, directions, uniq):
    cb, cm = _census_pair(dev, h, w, h + 1)
    cost = sk.census_cost_volume(cb, cm, d, min_disp)
    out = sk.sgm_wta_fused(cost, 8, 96, directions, min_disp, uniq)
    assert torch.equal(out, sgm_wta_fused_plain(cost, 8, 96, directions, min_disp, uniq))


@pytest.mark.parametrize("h,w,density", [(64, 128, 0.6), (77, 101, 0.45), (200, 300, 0.3)])
def test_label_propagate_kernel(dev, h, w, density):
    g = torch.Generator().manual_seed(h)
    valid = (torch.rand((h, w), generator=g) > density).to(dev)
    init = torch.where(valid, torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w), 2**31 - 1)
    conn_v = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    conn_h = torch.zeros_like(conn_v)
    conn_v[1:] = (valid[1:] & valid[:-1]).to(torch.uint8)
    conn_h[:, 1:] = (valid[:, 1:] & valid[:, :-1]).to(torch.uint8)
    for rounds in (1, 24):
        assert torch.equal(ck.propagate_labels(init, conn_v, conn_h, rounds),
                           ck.propagate_labels_plain(init, conn_v, conn_h, rounds))


def test_wrappers_count_launches_and_check_inputs(dev):
    cb, cm = _census_pair(dev, 16, 40, 0)
    wass_tpu_torch.reset_launch_counts()
    cost = sk.census_cost_volume(cb, cm, 8, 1)
    sk.sgm_wta_fused(cost, 8, 96, 8, 1, 1)
    assert wass_tpu_torch.launch_counts() == {"census_cost": 1, "sgm_wta_fused": 1, "label_propagate": 0}
    with pytest.raises(ValueError):
        sk.sgm_wta_fused(cost, 8, 96, 4, 1, 1)
    with pytest.raises(ValueError):
        sk.census_cost_volume(cb, cm.cpu(), 8, 1)
